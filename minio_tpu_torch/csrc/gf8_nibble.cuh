// The GF(2^8) product by split-nibble tables, shared by gf8_apply.cu
// (Kernel A) and rs_fused.cu (Kernel C): the GPU form of the PSHUFB method
// of klauspost/reedsolomon's galMulAVX2.  For a coefficient c, two 16-byte
// tables give c * x = Tlo[x & 15] ^ Thi[x >> 4] (ops/gf8.py::nibble_tables
// lays them out).  A table lives in a uint4 (registers); prmt picks its
// entries 0-7 and 8-15 by a nibble's low three bits, four data bytes at a
// time, and a byte mask from bit 3 selects between the two.  The
// selectors of a data word serve every coefficient it meets.
//
// store_chunk writes a shared row back to a device row at any alignment:
// aligned 16-byte stores, bytes only where a chunk leaves the row's
// stretch.

#pragma once

#include <stdint.h>

#include "ring.cuh"

namespace gf8 {

// PTX prmt: byte i of the result is byte (s >> 4i) & 7 of (b:a), or with
// bit 3 of that nibble set, its sign replicated.  __byte_perm ignores bit
// 3, which costs a mask of the selector before every permute.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// byte i of the result: 0xFF where bit 7 of byte i of x is set, else 0
__device__ __forceinline__ uint32_t prmt_sign(uint32_t x) { return prmt(x, 0, 0xBA98u); }

// selectors and masks of the four bytes of a data word
struct Sel {
  uint32_t slo, shi, mlo, mhi;
};

__device__ __forceinline__ Sel selectors(uint32_t x) {
  Sel s;
  const uint32_t tl = x & 0x07070707u, th = (x >> 4) & 0x07070707u;
  // nibble i of the low 16 bits: bits 0-2 of byte i's low / high nibble
  s.slo = __byte_perm(tl | (tl >> 4), 0, 0x0020);
  s.shi = __byte_perm(th | (th >> 4), 0, 0x0020);
  s.mlo = prmt_sign(x << 4);  // bit 3 of each low nibble
  s.mhi = prmt_sign(x);       // bit 3 of each high nibble
  return s;
}

// 16-entry table t looked up at the four nibbles of (s, m); the selector
// nibbles have bit 3 clear
__device__ __forceinline__ uint32_t lookup(const uint4& t, uint32_t s, uint32_t m) {
  const uint32_t a = prmt(t.x, t.y, s), b = prmt(t.z, t.w, s);
  return (a & ~m) | (b & m);
}

// shared parity row s (column c at s + c) -> device row tile [dst, dst + w):
// chunk q, aligned to the device address
__device__ __forceinline__ void store_chunk(uint8_t* dst, int w, const uint8_t* s, int q) {
  const int lo = 16 * q - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  if (lo >= w) return;
  if (lo >= 0 && lo + 16 <= w) {
    uint64_t a, b;
    ring::read16(s + lo, a, b);
    *reinterpret_cast<uint4*>(dst + lo) =
        make_uint4(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32),
                   static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32));
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (lo + t >= 0 && lo + t < w) dst[lo + t] = s[lo + t];
  }
}

}  // namespace gf8
