"""Static-index scatter via inverse-map gather.

Every resource-grid insertion in this framework uses a STATIC index
table, so a set-scatter can always be rewritten as a gather through the
precomputed inverse map, which needs no scatter-set (or complex scatter)
lowering. ``place`` builds a zero array with values at the indices; ``overlay``
writes them over an existing array via a select.

(Scatter-ADD — used for rate-matching soft combining — stays as
.at[].add.)
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp


@functools.lru_cache(maxsize=4096)
def _inverse_map(idx_key: bytes, n_idx: int, out_len: int) -> np.ndarray:
    idx = np.frombuffer(idx_key, dtype=np.int64)
    inv = np.full(out_len, n_idx, np.int32)   # default -> the zero slot
    inv[idx] = np.arange(n_idx, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=4096)
def _mask(idx_key: bytes, out_len: int) -> np.ndarray:
    idx = np.frombuffer(idx_key, dtype=np.int64)
    m = np.zeros(out_len, bool)
    m[idx] = True
    return m


def _key(idx: np.ndarray) -> bytes:
    return np.ascontiguousarray(np.asarray(idx, np.int64)).tobytes()


def place(vals, idx, out_len: int):
    """vals [..., n] + static idx [n] -> [..., out_len], zeros elsewhere."""
    idx = np.asarray(idx)
    n = idx.shape[0]
    assert vals.shape[-1] == n, (vals.shape, n)
    inv = _inverse_map(_key(idx), n, out_len)
    ext = jnp.concatenate(
        [vals, jnp.zeros((*vals.shape[:-1], 1), vals.dtype)], axis=-1)
    return ext[..., jnp.asarray(inv)]


def overlay(base, vals, idx):
    """Set vals at static idx of base's last axis (others preserved)."""
    idx = np.asarray(idx)
    out_len = base.shape[-1]
    placed = place(vals.astype(base.dtype), idx, out_len)
    mask = jnp.asarray(_mask(_key(idx), out_len))
    return jnp.where(mask, placed, base)
