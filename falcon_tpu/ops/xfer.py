"""Host->device upload of ragged peak arrays.

The peak arrays upload in their RAGGED form (flat values + offsets,
~0.7x the padded bytes) and are padded to the (n, max_peaks) device
layout by a scatter on device (:func:`upload_padded_peaks`).
"""

import functools
from typing import Tuple

import numpy as np


_pad_kernel = None


def _get_pad_kernel():
    global _pad_kernel
    if _pad_kernel is not None:
        return _pad_kernel
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n_rows", "pad_to"))
    def pad_ragged(values_mz, values_int, cum, total, n_rows, pad_to,
                   mz_fill):
        """Scatter flat ragged peaks into the (n_rows, pad_to) layout."""
        total_pad = values_mz.shape[0]
        pos = jnp.arange(total_pad, dtype=jnp.int32)
        row = jnp.searchsorted(cum, pos, side="right").astype(
            jnp.int32) - 1
        row = jnp.clip(row, 0, n_rows)  # n_rows = dump row for padding
        col = jnp.clip(pos - cum[row], 0, pad_to - 1)
        valid = pos < total
        row = jnp.where(valid, row, n_rows)
        mz = jnp.full((n_rows + 1, pad_to), mz_fill, jnp.float32)
        inten = jnp.zeros((n_rows + 1, pad_to), jnp.float32)
        mz = mz.at[row, col].set(
            jnp.where(valid, values_mz, mz_fill)
        )
        inten = inten.at[row, col].set(
            jnp.where(valid, values_int, 0.0)
        )
        return mz[:n_rows], inten[:n_rows]

    _pad_kernel = pad_ragged
    return pad_ragged


def upload_padded_peaks(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    intensity_flat: np.ndarray,
    row_indices: np.ndarray,
    pad_to: int,
    n_rows: int,
    mz_fill: float = -1e6,
) -> Tuple:
    """Ragged peaks -> DEVICE-resident padded (n_rows, pad_to) arrays.

    Same layout contract as ``store.padded_peaks`` (padding m/z =
    ``mz_fill``, intensity = 0; rows beyond ``len(row_indices)`` are all
    padding), but the transfer is the ragged bytes (~0.7x) and the
    padding scatter runs on device.
    """
    import jax
    import jax.numpy as jnp

    row_indices = np.asarray(row_indices, np.int64)
    starts = offsets[row_indices]
    lengths = (offsets[row_indices + 1] - starts).astype(np.int64)
    if lengths.max(initial=0) > pad_to:
        raise ValueError(
            f"spectrum with {int(lengths.max())} peaks exceeds "
            f"pad_to={pad_to}"
        )
    flat_idx = (
        starts.repeat(lengths)
        + _ragged_arange(lengths)
    )
    sel_mz = np.ascontiguousarray(mz_flat[flat_idx], np.float32)
    sel_int = np.ascontiguousarray(intensity_flat[flat_idx], np.float32)
    total = len(sel_mz)
    total_pad = 1024
    while total_pad < total:
        total_pad *= 2
    pad = total_pad - total
    cum = np.zeros(n_rows + 1, np.int32)
    np.cumsum(lengths, out=cum[1: len(lengths) + 1])
    cum[len(lengths) + 1:] = total
    return _get_pad_kernel()(
        jax.device_put(np.concatenate([sel_mz, np.zeros(pad, np.float32)])),
        jax.device_put(np.concatenate([sel_int, np.zeros(pad, np.float32)])),
        jnp.asarray(cum), jnp.int32(total), int(n_rows), int(pad_to),
        jnp.float32(mz_fill),
    )


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for the given segment lengths."""
    total = int(lengths.sum())
    seg_starts = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(lengths)[:-1]]
    )
    return np.arange(total, dtype=np.int64) - np.repeat(
        seg_starts, lengths
    )
