"""Small shared utilities."""

from __future__ import annotations


def close_quietly(it) -> None:
    """Close an iterator or generator that has a ``close``, swallowing
    what its teardown raises: how a streaming stage (a reader, a
    decompressor, a re-chunker) passes an early end on to its source."""
    close = getattr(it, "close", None)
    if close is not None:
        try:
            close()
        except Exception:  # noqa: BLE001 — the source is already failing
            pass
