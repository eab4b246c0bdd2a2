"""The FULL multi-chip ANN clustering pipeline under one mesh.

``--devices N`` originally sharded only the banded k-NN search; this
module runs the complete device chain of ``cluster/ann_engine.py`` —
vectorize -> banded k-NN -> exact rerank -> DBSCAN label propagation —
as ONE jitted ``shard_map`` over a ``spectra`` row mesh, plus a sharded
medoid-score reduction.  The reference has no distributed anything
(SURVEY.md §2.4); the design principles:

- rows (spectra, sorted by precursor m/z) are the shard axis; all
  per-row work (vectorize, rerank scoring, core detection) is local;
- the precursor band constraint bounds every query's candidates to its
  own shard ± 1 neighbor shard, so k-NN and rerank need only a *halo*
  of the adjacent shards — two ``ppermute``s each of vectors and peak
  arrays over ICI, O(local rows) communication independent of corpus
  size;
- DBSCAN connected components run as min-label propagation with a
  replicated label vector: each device folds its local edges into the
  global labels and a ``pmin`` allreduce merges them, with pointer
  jumping on the (replicated) labels for O(log diameter) convergence —
  semantics identical to the single-device kernel (``ops/density.py``);
- medoid scores are a data-parallel segment-sum ``psum`` over the
  sharded vectors (the gradient-allreduce pattern).

Label parity with the single-device engine is enforced by
``tests/test_multichip.py``.
"""

from typing import Optional, Tuple

import numpy as np

from ..ops.knn import NEG, _pow2_at_least

_SPECS = {}


def _build_pipeline(mesh, axis, statics):
    """Construct the jitted shard_map pipeline for one static config."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.rerank import rerank_scan_body
    from ..ops.vectorize import vectorize_body
    from .sharded_knn import _local_banded_topk

    (k_ann, k_final, tol_is_da, block_rows, window, min_bound, bin_size,
     n_bins, dim_padded, fragment_tol, rounds, chunk_q, chunk_c,
     min_samples, min_matches, has_rt) = statics

    n_dev = mesh.devices.size

    def local_fn(mz_local, int_local, pmz_local, rt_local, mapping,
                 col_starts, n, eps, tol_mass, rt_tol):
        local_rows = mz_local.shape[0]
        n_pad = n_dev * local_rows
        my = jax.lax.axis_index(axis)
        base = (my - 1) * local_rows  # global row id of halo column 0
        row_global = my * local_rows + jnp.arange(local_rows,
                                                  dtype=jnp.int32)

        # 1. Vectorize locally (no communication).
        vectors = vectorize_body(
            mz_local, int_local, mapping, min_bound, bin_size, n_bins,
            dim_padded, True,
        )

        # 2. Banded k-NN with a one-shard halo (ppermute exchange).
        sims, neigh = _local_banded_topk(
            vectors, pmz_local, col_starts, tol_mass,
            axis=axis, k=k_ann, tol_is_da=tol_is_da,
            block_rows=block_rows, window=window,
        )

        # Halo-extend the peak arrays for the rerank gather (same
        # pattern as the vector halo inside _local_banded_topk).
        right_to_left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        left_to_right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        pool_mz = jnp.concatenate([
            jax.lax.ppermute(mz_local, axis, left_to_right),
            mz_local,
            jax.lax.ppermute(mz_local, axis, right_to_left),
        ])
        pool_int = jnp.concatenate([
            jax.lax.ppermute(int_local, axis, left_to_right),
            int_local,
            jax.lax.ppermute(int_local, axis, right_to_left),
        ])

        # Optional RT filter on the CANDIDATE lists (before rerank, like
        # the single-device path, so rt-excluded candidates never
        # displace valid ones in the final top-k).
        if has_rt:
            rt_pool = jnp.concatenate([
                jax.lax.ppermute(rt_local, axis, left_to_right),
                rt_local,
                jax.lax.ppermute(rt_local, axis, right_to_left),
            ])
            pool_idx = jnp.clip(neigh - base, 0, 3 * local_rows - 1)
            bad = (neigh >= 0) & (
                jnp.abs(rt_pool[pool_idx] - rt_local[:, None]) > rt_tol
            )
            sims = jnp.where(bad, NEG, sims)
            neigh = jnp.where(bad, -1, neigh)

        # 3. Exact rerank against the halo pool.
        pool_ids = jnp.where(neigh >= 0, neigh - base, -1)
        scores, ids_pool, n_match = rerank_scan_body(
            mz_local, int_local, pool_mz, pool_int,
            pool_ids.astype(jnp.int32), fragment_tol, k_final, rounds,
            chunk_q, chunk_c,
        )
        ids_global = jnp.where(ids_pool >= 0, ids_pool + base, -1)
        if min_matches > 0:
            low = (ids_global >= 0) & (n_match < min_matches)
            scores = jnp.where(low, 0.0, scores)

        # 4. DBSCAN (semantics of ops/density.py): core detection local,
        # components via replicated min-label propagation + pmin.
        in_range = row_global < n
        valid = (ids_global >= 0) & in_range[:, None]
        within = valid & ((1.0 - scores) <= eps)
        n_within = within.sum(axis=1) + 1
        core_local = (n_within >= min_samples) & in_range
        core_full = jax.lax.all_gather(core_local, axis, tiled=True)
        neigh_safe = jnp.clip(ids_global, 0, n_pad - 1).astype(jnp.int32)
        edge = within & core_local[:, None] & core_full[neigh_safe]
        tgt = jnp.where(edge, neigh_safe, n_pad)

        def cond(state):
            _, changed, it = state
            return jnp.logical_and(changed, it < n_pad)

        def body(state):
            labels, _, it = state
            own = labels[row_global]
            # Out-edges: min neighbor label onto own rows.
            neigh_labels = jnp.where(edge, labels[neigh_safe], n_pad)
            new_local = jnp.minimum(own, jnp.min(neigh_labels, axis=1))
            # Fold local updates + in-edge scatter-min into a full-length
            # contribution vector, merged across devices with pmin.
            contrib = jnp.full((n_pad + 1,), n_pad, jnp.int32)
            contrib = contrib.at[row_global].min(new_local)
            contrib = contrib.at[tgt.reshape(-1)].min(
                jnp.broadcast_to(own[:, None], tgt.shape).reshape(-1)
            )
            new = jax.lax.pmin(contrib[:n_pad], axis)
            new = jnp.minimum(new, labels)
            # Pointer jumping on the replicated labels (identical on all
            # devices): label ids are row ids, so label[label[x]] is
            # also x's component.
            safe = jnp.minimum(new, n_pad - 1)
            new = jnp.minimum(new, new[safe])
            safe = jnp.minimum(new, n_pad - 1)
            new = jnp.minimum(new, new[safe])
            return new, jnp.any(new != labels), it + 1

        labels0 = jnp.where(
            core_full, jnp.arange(n_pad, dtype=jnp.int32),
            jnp.int32(n_pad),
        )
        labels, _, _ = jax.lax.while_loop(
            cond, body, (labels0, jnp.bool_(True), jnp.int32(0))
        )
        comp_local = jnp.where(core_local, labels[row_global], -1)

        # Border points: most-similar core neighbor within eps.
        core_neigh = within & core_full[neigh_safe]
        best_pos = jnp.argmax(jnp.where(core_neigh, scores, NEG), axis=1)
        best_id = jnp.take_along_axis(
            ids_global, best_pos[:, None], axis=1
        )[:, 0]
        has_core = core_neigh.any(axis=1)
        border = jnp.where(
            has_core & ~core_local & in_range, best_id, -1
        ).astype(jnp.int32)
        return comp_local, core_local, border, vectors

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(axis),
                      P(), P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
            check_vma=False,
        )
    )


def _band_windows(mzs, tol_mass, tol_is_da, n_dev, local, block_rows):
    """Per-(device, block) halo-relative column window starts.

    Returns (starts, window) or None when a band exceeds the one-shard
    halo (caller falls back to single-device)."""
    from ..ops.knn import band_bounds

    n = len(mzs)
    # f32-consistent bounds shared with every other kNN path: the device
    # kernel compares f32 m/z, so the halo window must cover its f32
    # acceptance region (ops/knn.band_bounds).
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)
    n_blocks = local // block_rows
    starts = np.zeros((n_dev, n_blocks), np.int32)
    max_span = block_rows
    for d in range(n_dev):
        halo_lo = (d - 1) * local
        for b in range(n_blocks):
            r0 = d * local + b * block_rows
            if r0 >= n:
                starts[d, b] = local
                continue
            r1 = min(r0 + block_rows, n)
            lo = int(band_lo[r0])
            hi = max(int(band_hi[r1 - 1]), r1)
            if lo < halo_lo or hi > (d + 2) * local:
                return None
            max_span = max(max_span, hi - lo)
            starts[d, b] = lo - halo_lo
    window = min(_pow2_at_least(max_span, block_rows), 3 * local)
    starts = np.minimum(np.maximum(starts, 0), 3 * local - window)
    return starts, window


def ann_cluster_sharded(
    mz_pad: np.ndarray,       # (n, P) padded peak m/z, SORTED by precursor
    int_pad: np.ndarray,      # (n, P) L2-normalized intensities
    precursor_mzs: np.ndarray,  # (n,) sorted
    rts: Optional[np.ndarray],
    hasher,
    tol_mass: float,
    tol_mode: str,
    k_ann: int,
    k_final: int,
    fragment_tol: float,
    eps: float,
    min_samples: int,
    min_matches: int,
    rt_tol: Optional[float],
    mesh,
    block_rows: int = 1024,
    rounds: int = 4,
    chunk_c: int = 16,
    axis: str = "spectra",
):
    """Run the full sharded pipeline; returns (labels, vectors, n_pad).

    ``labels``: DBSCAN labels (n,) with -1 noise, numbered by first
    occurrence — identical to ``ops.density.dbscan`` on the same input.
    ``vectors``: the row-sharded hashed vectors (device array, n_pad
    rows) for the medoid stage.  Returns None when a precursor band is
    wider than a one-shard halo.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.density import labels_from_parts

    n, p = mz_pad.shape
    n_dev = mesh.devices.size
    mzs = np.asarray(precursor_mzs, np.float64)
    tol_is_da = tol_mode == "Da"
    local = _pow2_at_least((n + n_dev - 1) // n_dev, 512)
    n_pad = local * n_dev
    block_rows = min(block_rows, local)
    bw = _band_windows(mzs, tol_mass, tol_is_da, n_dev, local, block_rows)
    if bw is None:
        return None
    starts, window = bw
    k_ann = min(k_ann, window)
    k_final = min(k_final, k_ann)
    chunk_q = min(512, local)

    statics = (
        int(k_ann), int(k_final), bool(tol_is_da), int(block_rows),
        int(window), float(hasher.min_bound), float(hasher.bin_size),
        int(hasher.n_bins), int(hasher.dim_padded), float(fragment_tol),
        int(rounds), int(chunk_q), int(chunk_c), int(min_samples),
        int(min_matches), rt_tol is not None,
    )
    key = (id(mesh), axis, statics)
    fn = _SPECS.get(key)
    if fn is None:
        fn = _build_pipeline(mesh, axis, statics)
        _SPECS[key] = fn

    mz_full = np.full((n_pad, p), -1e6, np.float32)
    int_full = np.zeros((n_pad, p), np.float32)
    mz_full[:n], int_full[:n] = mz_pad, int_pad
    pmz_full = np.full(n_pad, np.inf, np.float32)
    pmz_full[:n] = mzs
    rt_full = np.full(n_pad, np.inf, np.float32)
    if rts is not None:
        rt_full[:n] = rts

    shard = NamedSharding(mesh, P(axis))
    comp, core, border, vectors = fn(
        jax.device_put(mz_full, shard),
        jax.device_put(int_full, shard),
        jax.device_put(pmz_full, shard),
        jax.device_put(rt_full, shard),
        jnp.asarray(hasher.mapping),
        jax.device_put(starts, shard),
        jnp.int32(n),
        jnp.float32(eps),
        jnp.float32(tol_mass),
        jnp.float32(np.inf if rt_tol is None else rt_tol),
    )
    labels = labels_from_parts(
        np.asarray(comp)[:n], np.asarray(core)[:n],
        np.asarray(border)[:n], n,
    )
    return labels, vectors, n_pad


_MEDOID_FNS = {}


def sharded_medoid_scores(
    vectors, seg: np.ndarray, n_seg: int, mesh, axis: str = "spectra"
) -> np.ndarray:
    """Per-row medoid scores v_i . sum_{segment(i)} v_j over the mesh.

    ``vectors``: row-sharded (n_pad, D) device array from
    :func:`ann_cluster_sharded`; ``seg``: (n,) segment per row.  The
    segment sums are a local scatter-add + ``psum`` (data-parallel
    allreduce); only n float32 scores return to the host.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_pad = vectors.shape[0]
    n = len(seg)
    n_seg_pad = 256
    while n_seg_pad < n_seg:
        n_seg_pad *= 2
    key = (id(mesh), axis, n_seg_pad)
    fn = _MEDOID_FNS.get(key)
    if fn is None:
        def local_fn(v, seg_local):
            sums = jnp.zeros((n_seg_pad, v.shape[1]), jnp.float32)
            sums = sums.at[seg_local].add(v)
            sums = jax.lax.psum(sums, axis)
            return jnp.einsum("nd,nd->n", v, sums[seg_local],
                              precision=jax.lax.Precision.HIGHEST)

        fn = jax.jit(
            jax.shard_map(
                local_fn,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
        )
        _MEDOID_FNS[key] = fn

    # Padding rows scatter their zero vectors into segment 0 — harmless.
    seg_full = np.zeros(n_pad, np.int32)
    seg_full[:n] = seg
    shard = NamedSharding(mesh, P(axis))
    out = fn(vectors, jax.device_put(seg_full, shard))
    return np.asarray(out)[:n]
