"""The host data engine's Python surface (port of
``multimodalfilter_tpu/native/__init__.py``): the loaders' window and row
gathers, z-score normalisation, stride-2 image subsampling, per-frame
masking and eval batching.

The JAX package runs these in a C++ library built at first use, each
function bitwise equal to its numpy fallback. The port keeps the numpy
expressions alone: it gathers its training batches on the card, and the
remaining host passes run once per dataset load. So ``available()`` is False
and ``build_error()`` says why; the functions compute exactly what the JAX
package's numpy path computes, and take its ``n_threads`` argument, which
changes nothing here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_NO_ENGINE = ("the PyTorch port has no native host engine: it gathers its batches on "
              "the card, and these functions are the JAX package's numpy expressions")


def available() -> bool:
    """False: the port builds no native library."""
    return False


def build_error() -> Optional[str]:
    """Why there is no native engine."""
    return _NO_ENGINE


def window_gather(src: np.ndarray, starts: np.ndarray, window_len: int,
                  n_threads: int = 0) -> np.ndarray:
    """np.stack([src[s : s + window_len] for s in starts]) for `src` of
    shape (T, ...), dtype preserved. Windows may overlap."""
    del n_threads
    src = np.ascontiguousarray(src)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.ndim != 1:
        raise ValueError(f"starts must be 1-D, got shape {starts.shape}")
    if starts.size and (int(starts.min()) < 0
                        or int(starts.max()) + window_len > src.shape[0]):
        raise ValueError(
            f"window [start, start+{window_len}) out of bounds for src with "
            f"{src.shape[0]} rows (starts min {int(starts.min())}, "
            f"max {int(starts.max())})"
        )
    out = np.empty((starts.size, window_len) + src.shape[1:], dtype=src.dtype)
    for i, s in enumerate(starts):
        out[i] = src[s : s + window_len]
    return out


def row_gather(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """src[idx] for `src` of shape (T, ...), dtype preserved."""
    del n_threads
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise ValueError(
            f"index out of bounds for src with {src.shape[0]} rows "
            f"(idx min {int(idx.min())}, max {int(idx.max())})"
        )
    return src[idx]


def normalize(array: np.ndarray, mean: np.ndarray, std: np.ndarray,
              n_threads: int = 0) -> np.ndarray:
    """(array - mean) / std over the trailing axes, in float32, into a fresh
    array."""
    del n_threads
    src = np.ascontiguousarray(array, dtype=np.float32)
    mean = np.ascontiguousarray(mean, dtype=np.float32).reshape(-1)
    std = np.ascontiguousarray(std, dtype=np.float32).reshape(-1)
    trail = src.shape[1:] if src.ndim > 1 else ()
    row_elems = int(np.prod(trail)) if trail else 1
    if mean.size != row_elems or std.size != row_elems:
        raise ValueError(f"mean and std of {mean.size} and {std.size} values for rows "
                         f"of {row_elems}")
    return ((src - mean.reshape(trail)) / std.reshape(trail)).astype(np.float32)


def subsample2(images: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """images[:, ::2, ::2] for float32 (T, H, W), contiguous."""
    del n_threads
    images = np.ascontiguousarray(images, dtype=np.float32)
    if images.ndim != 3:
        raise ValueError(f"images must be (T, H, W), got shape {images.shape}")
    return np.ascontiguousarray(images[:, ::2, ::2])


def apply_mask(images: np.ndarray, keep: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """images * keep.reshape(T, 1, ..., 1), a scalar per timestep, into a
    fresh float32 array."""
    del n_threads
    src = np.ascontiguousarray(images, dtype=np.float32)
    keep = np.ascontiguousarray(keep, dtype=np.float32).reshape(-1)
    if keep.size != src.shape[0]:
        raise ValueError(f"{keep.size} mask values for {src.shape[0]} timesteps")
    return src * keep.reshape((-1,) + (1,) * (src.ndim - 1))


def stack_axis1(arrays: Sequence[np.ndarray], t_min: int, n_threads: int = 0) -> np.ndarray:
    """np.stack([a[:t_min] for a in arrays], axis=1) for float32 (T_i, ...)
    arrays with one trailing shape (eval batching)."""
    del n_threads
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    if not arrays:
        raise ValueError("empty batch")
    trail = arrays[0].shape[1:]
    for a in arrays:
        if a.shape[0] < t_min or a.shape[1:] != trail:
            raise ValueError(f"array of shape {a.shape} in a batch of {t_min} steps of {trail}")
    return np.stack([a[:t_min] for a in arrays], axis=1)
