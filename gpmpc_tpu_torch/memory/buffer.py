"""Padding buckets of the stored-point buffer (gpmpc_tpu/memory/buffer.py).

The buffer pads the stored points to one of a small set of sizes, so the
planner sees few distinct shapes. Only ``bucket_size`` is ported so far.
"""

from __future__ import annotations

from typing import Optional

_BUCKETS = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048)


def bucket_size(n: int, capacity: Optional[int] = None) -> int:
    """Smallest bucket >= n; beyond the largest, the next multiple of 512.
    ``capacity`` is accepted for the JAX signature and unused, as there."""
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512
