"""CRC-32C (Castagnoli) through the native core (≙ butil/crc32c.h —
hardware SSE4.2 when available, sliced software fallback otherwise).
Matches the iSCSI/ext4/leveldb polynomial, so values interoperate with
other crc32c implementations."""

from __future__ import annotations

from brpc_tpu_torch._native import lib


def crc32c(data: bytes, init: int = 0) -> int:
    """Checksum of `data`; pass a previous result as `init` to stream."""
    return int(lib().trpc_crc32c_extend(init & 0xFFFFFFFF, data, len(data)))


def crc32c_hardware() -> bool:
    """True when the SSE4.2 instruction path is in use."""
    return bool(lib().trpc_crc32c_hardware())
