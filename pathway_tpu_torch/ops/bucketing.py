"""Shape bucketing: bound the set of shapes under dynamic batch sizes.

The port's own copy of ``pathway_tpu/ops/bucketing.py`` (pure numpy).
Streaming epochs produce arbitrary batch sizes; rounding every dynamic
dimension up to a power of two (with a floor) keeps the number of
distinct shapes that reach the kernels logarithmic, and pads update
batches the same way the JAX package does, so both packages assign and
pad slots identically.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bucket_size", "pad_rows", "pad_dim"]


def bucket_size(n: int, min_bucket: int = 8, max_bucket: int | None = None) -> int:
    """Smallest power of two >= n (and >= min_bucket), optionally clamped."""
    if n <= 0:
        return min_bucket
    b = max(min_bucket, 1 << (int(n - 1).bit_length()))
    if max_bucket is not None:
        b = min(b, max_bucket)
    return max(b, n) if max_bucket is None else b


def pad_rows(arr: np.ndarray, bucket: int, fill: float | int = 0) -> np.ndarray:
    """Pad axis 0 of ``arr`` up to ``bucket`` rows with ``fill``."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    pad = np.full((bucket - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def pad_dim(arr: np.ndarray, axis: int, size: int, fill: float | int = 0) -> np.ndarray:
    """Pad ``axis`` of ``arr`` up to ``size`` with ``fill``."""
    n = arr.shape[axis]
    if n == size:
        return arr
    shape = list(arr.shape)
    shape[axis] = size - n
    pad = np.full(shape, fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=axis)
