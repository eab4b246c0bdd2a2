"""Multi-chip banded k-NN with halo exchange.

Spectra are sorted by precursor m/z, so sharding rows contiguously over
the device mesh means every query's tolerance band lives in its own
shard plus (at most) the neighboring shards.  Each device therefore
needs only a *halo* — its left and right neighbor shards, exchanged with
two ``ppermute`` collectives over ICI — instead of an all-gather of the
full vector matrix: communication is O(local rows), independent of the
total corpus size (the scaling-book halo-exchange pattern; this also
fixes the reference's dropped cross-chunk pairs at block boundaries,
reference ``falcon/cluster/cluster.py:198-207``, because bands spanning
shard edges are still fully scored).

Within a shard the search is the same one-dispatch blocked
matmul + fused top-k scan as the single-chip path (``ops/knn.py``), with
column windows dynamic-sliced out of the halo-extended local matrix.

Precondition (checked on host): every band must fit inside
[shard - 1 shard, shard + 1 shard].  With the default precursor
tolerance (20 ppm) a band covers a few hundred rows while a shard covers
n/n_devices, so this holds for any realistic sharded run; the caller
falls back to the single-device path otherwise.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.knn import NEG, _pow2_at_least, band_bounds


def _local_banded_topk(
    vectors,      # (L, D) local rows
    mzs,          # (L,) local precursor m/z (padded rows: +inf)
    col_starts,   # (n_blocks,) HALO-RELATIVE column window starts
    tol_mass,     # scalar
    *,
    axis: str,
    k: int,
    tol_is_da: bool,
    block_rows: int,
    window: int,
):
    local_rows = vectors.shape[0]
    col_starts = col_starts.reshape(-1)  # (1, n_blocks) shard -> flat
    my = jax.lax.axis_index(axis)
    n_dev = jax.lax.axis_size(axis)

    # Halo exchange: receive the right neighbor's shard from the left
    # (and vice versa).  Edge devices receive a wrapped shard; its
    # columns are masked out by the global-index bounds below.
    right_to_left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    left_to_right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    halo_r_vec = jax.lax.ppermute(vectors, axis, left_to_right)
    halo_r_mz = jax.lax.ppermute(mzs, axis, left_to_right)
    halo_l_vec = jax.lax.ppermute(vectors, axis, right_to_left)
    halo_l_mz = jax.lax.ppermute(mzs, axis, right_to_left)
    # halo layout: [left shard | own shard | right shard]
    cols = jnp.concatenate([halo_r_vec, vectors, halo_l_vec])
    col_mz = jnp.concatenate([halo_r_mz, mzs, halo_l_mz])
    base = (my - 1) * local_rows  # global row id of halo column 0

    # Mask wrapped halo columns (device 0's "left" shard, device n-1's
    # "right" shard) via their global index validity.
    col_global = base + jnp.arange(3 * local_rows, dtype=jnp.int32)
    col_valid = (col_global >= 0) & (col_global < n_dev * local_rows)
    col_mz = jnp.where(col_valid, col_mz, jnp.inf)

    n_blocks = local_rows // block_rows

    def step(_, b):
        r0 = b * block_rows
        c0 = col_starts[b]
        q = jax.lax.dynamic_slice_in_dim(vectors, r0, block_rows)
        q_mz = jax.lax.dynamic_slice_in_dim(mzs, r0, block_rows)
        c = jax.lax.dynamic_slice_in_dim(cols, c0, window)
        c_mz = jax.lax.dynamic_slice_in_dim(col_mz, c0, window)
        sims = jnp.dot(q, c.T, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        diff = q_mz[:, None] - c_mz[None, :]
        if tol_is_da:
            mass_diff = jnp.abs(diff)
        else:
            mass_diff = jnp.abs(diff / c_mz[None, :] * 1e6)
        q_global = my * local_rows + r0 + jnp.arange(
            block_rows, dtype=jnp.int32
        )
        c_global = base + c0 + jnp.arange(window, dtype=jnp.int32)
        valid = (
            (mass_diff <= tol_mass)
            & (q_global[:, None] != c_global[None, :])
            & jnp.isfinite(c_mz)[None, :]
        )
        sims = jnp.where(valid, sims, NEG)
        top_scores, top_pos = jax.lax.top_k(sims, k)
        top_idx = jnp.where(
            top_scores > NEG,
            base + c0 + top_pos.astype(jnp.int32),
            -1,
        )
        return 0, (top_scores, top_idx)

    _, (scores, idx) = jax.lax.scan(
        step, 0, jnp.arange(n_blocks, dtype=jnp.int32)
    )
    return scores.reshape(local_rows, k), idx.reshape(local_rows, k)


def knn_banded_sharded(
    vectors: np.ndarray,
    precursor_mzs: np.ndarray,
    tol_mass: float,
    tol_mode: str,
    k: int,
    mesh: Mesh,
    block_rows: int = 1024,
    axis: str = "spectra",
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Banded k-NN sharded over a device mesh.

    Same contract as ``ops.knn.knn_banded`` (sorted ``precursor_mzs``,
    returns (sims, neighbor ids) with -2/-1 for missing), executed with
    rows sharded over ``mesh`` and halo exchange for cross-shard bands.
    Returns None when a band is too wide for a one-shard halo (caller
    should fall back to the single-device / IVF path).
    """
    n = len(precursor_mzs)
    n_dev = mesh.devices.size
    mzs = np.asarray(precursor_mzs, np.float64)
    tol_is_da = tol_mode == "Da"
    # f32-consistent bounds shared with the banded scan (ops/knn.py):
    # the kernel compares f32 m/z, so the halo window must cover its f32
    # acceptance region.
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)

    # Local rows: power of two, divisible into blocks.
    local = _pow2_at_least((n + n_dev - 1) // n_dev, 512)
    n_pad = local * n_dev
    block_rows = min(block_rows, local)
    n_blocks = local // block_rows

    # Per (device, block): window start relative to that device's halo
    # array [(dev-1)*local, (dev+2)*local).
    starts = np.zeros((n_dev, n_blocks), np.int32)
    max_span = block_rows
    ok = True
    for d in range(n_dev):
        halo_lo = (d - 1) * local
        for b in range(n_blocks):
            r0 = d * local + b * block_rows
            if r0 >= n:
                starts[d, b] = local  # own shard start (all padding)
                continue
            r1 = min(r0 + block_rows, n)
            lo = int(band_lo[r0])
            hi = max(int(band_hi[r1 - 1]), r1)
            if lo < halo_lo or hi > (d + 2) * local:
                ok = False  # band wider than one-shard halo
            max_span = max(max_span, hi - lo)
            starts[d, b] = lo - halo_lo
    if not ok:
        return None
    window = min(_pow2_at_least(max_span, block_rows), 3 * local)
    starts = np.minimum(np.maximum(starts, 0), 3 * local - window)

    d_model = vectors.shape[1]
    v_pad = np.zeros((n_pad, d_model), np.float32)
    v_pad[:n] = np.asarray(vectors, np.float32)
    mz_pad = np.full(n_pad, np.inf, np.float32)
    mz_pad[:n] = mzs

    local_fn = functools.partial(
        _local_banded_topk,
        axis=axis,
        k=int(min(k, window)),
        tol_is_da=tol_is_da,
        block_rows=int(block_rows),
        window=int(window),
    )
    step = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P()),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
    )
    scores, idx = step(
        jax.device_put(v_pad, NamedSharding(mesh, P(axis))),
        jax.device_put(mz_pad, NamedSharding(mesh, P(axis))),
        jax.device_put(
            starts, NamedSharding(mesh, P(axis))
        ),
        jnp.float32(tol_mass),
    )
    out_scores = np.array(scores[:n])
    out_idx = np.asarray(idx)[:n].astype(np.int64)
    if out_scores.shape[1] < k:
        pad = k - out_scores.shape[1]
        out_scores = np.concatenate(
            [out_scores, np.full((n, pad), float(NEG), np.float32)],
            axis=1,
        )
        out_idx = np.concatenate(
            [out_idx, np.full((n, pad), -1, np.int64)], axis=1
        )
    bad = out_idx >= n
    out_scores[bad] = float(NEG)
    out_idx[bad] = -1
    return out_scores, out_idx
