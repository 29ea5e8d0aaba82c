"""The MessagePack subset that xl.meta uses: maps, arrays, str, bin, int,
float, bool and nil.

``packb`` emits exactly what ``msgpack.packb(obj, use_bin_type=True)``
emits for these types (smallest int form, positive ints unsigned, str8
allowed, floats as float64), so xl.meta written here is byte-identical to
``minio_tpu``'s and each package reads the other's drives.  ``unpackb``
decodes like ``msgpack.unpackb(buf, raw=False, strict_map_key=False)``
for the same subset and raises ValueError on anything else;
``unpack_stream`` decodes a run of records back to back, as
``msgpack.Unpacker`` does, and gives each record's end offset.
"""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int | None, fix_max: int, codes,
              out: bytearray) -> None:
    """Length header: fix form when ``n < fix_max``, else 8/16/32-bit."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += bytes((0xCC, x))
    elif 0 <= x <= 0xFFFF:
        out.append(0xCD)
        out += struct.pack(">H", x)
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(0xCE)
        out += struct.pack(">I", x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += struct.pack(">Q", x)
    elif -0x80 <= x:
        out.append(0xD0)
        out += struct.pack(">b", x)
    elif -0x8000 <= x:
        out.append(0xD1)
        out += struct.pack(">h", x)
    elif -0x80000000 <= x:
        out.append(0xD2)
        out += struct.pack(">i", x)
    elif -0x8000000000000000 <= x:
        out.append(0xD3)
        out += struct.pack(">q", x)
    else:
        raise OverflowError("Integer value out of range")


# fixed-width scalars: code -> (struct format, size)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
            0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed: code -> (kind, length format, size)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2),
          0xDB: ("str", ">I", 4), 0xC4: ("bin", ">B", 1),
          0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def unpackb(buf) -> object:
    buf = bytes(buf)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes")
    return obj


def unpack_stream(buf):
    """(record, end offset) for each whole record of ``buf``, in order.
    Stops quietly at a truncated last record; a record that cannot be
    decoded raises ValueError after the good ones before it."""
    buf = bytes(buf)
    pos = 0
    while pos < len(buf):
        try:
            obj, end = _unpack(buf, pos)
        except _Truncated:
            return
        yield obj, end
        pos = end


class _Truncated(ValueError):
    pass


def _take(buf: bytes, pos: int, n: int) -> bytes:
    if pos + n > len(buf):
        raise _Truncated("truncated msgpack data")
    return buf[pos:pos + n]


def _unpack(buf: bytes, pos: int):
    code = _take(buf, pos, 1)[0]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack(fmt, _take(buf, pos, size))[0], pos + size
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack(fmt, _take(buf, pos, size))[0]
        pos += size
    else:
        raise ValueError(f"unsupported msgpack type 0x{code:02x}")
    if kind == "str":
        return _take(buf, pos, n).decode("utf-8"), pos + n
    if kind == "bin":
        return _take(buf, pos, n), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        d[k] = v
    return d, pos
