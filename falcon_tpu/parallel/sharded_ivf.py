"""Multi-chip IVF list scan: corpus slab sharded, ring-rotated.

The index this shards replaces the reference's per-bucket Faiss IVF
(published algorithm, reference ``README.md:132-142``; the reference
itself has no distribution story at all — SURVEY.md §2.4).

The IVF index's 3-D slab layout (``ops/ivf.py``: ``(n_lists, lb, D)``,
probing = whole-slab block gathers) shards naturally on the LIST axis.
Self-search (the engine's case — queries == corpus) then runs as a ring:
each device keeps its own query lists resident and the corpus shard
rotates around the mesh with ``ppermute`` (the scaling-book ring-matmul
pattern).  At ring step ``s`` a device holds corpus block
``(me + s) % N`` and scores, for every local query list, the probes that
fall inside that block; a running top-k merges the partial results, so
after N steps every query has seen all ``n_probe`` of its lists exactly
once.  Communication is the corpus slab moving once around the ring —
O(corpus / N) per step per device over the device interconnect;
per-device working set is its query shard plus one rotating corpus
shard (plus the score chunk), which is how list counts beyond one
device's memory scale onto several.

The index itself is still BUILT on the default device and resharded by
``device_put`` — sharding the k-means/build phase is not needed until
corpora outgrow a single chip's build memory (the capacity-capped
layout keeps build memory deterministic, ``ops/ivf.py``).

Label parity with the single-device ``IVFIndex.search`` is exact modulo
top-k tie order (tests/test_multichip.py).
"""

import functools
from typing import Optional, Tuple

import numpy as np


def ivf_search_sharded(
    index,
    k: int,
    n_probe: int,
    tol_mass: float,
    tol_mode: str,
    mesh,
    precise: bool = False,
    axis: str = "spectra",
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Sharded SELF-search of ``index`` (an ``ops.ivf.IVFIndex``).

    Same contract as ``index.search(vectors, ...)`` in the self-search
    case: returns (similarities (n, k), neighbor row ids (n, k)) with
    -2 / -1 for missing.  Returns None when the mesh does not divide
    the list count (caller falls back to the single-device search).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.ivf import NEG

    n_dev = mesh.devices.size
    n_lists = index.n_lists
    if n_dev > n_lists or n_lists % n_dev != 0:
        return None
    n_probe = min(n_probe, n_lists)
    lb = index._lb
    qlb = lb
    s_lists = n_lists // n_dev
    k_eff = min(k, n_probe * lb)
    probe_ids = index._probe_ids(n_probe)
    tol_is_da = tol_mode == "Da"
    scan_dtype = jnp.float32 if precise else jnp.bfloat16

    # Chunk local query lists so the (chunk, qlb, n_probe, lb) score
    # block stays ~<= 256 MB (the single-device scan's budget).
    chunk = 1
    while (chunk * 2 * qlb * n_probe * lb * 4 <= 256 * 2**20
           and chunk * 2 <= s_lists):
        chunk *= 2

    def local_fn(q3, c3, cm, cr, probes):
        me = jax.lax.axis_index(axis)
        # Local query lists stay resident; with an asymmetric index
        # (rank_vectors, e.g. the spread-UB ranking) they come from the
        # query slab set instead of the corpus slabs.
        q = q3.astype(scan_dtype)
        qm, qr = cm, cr

        def ring(carry, s):
            cc, ccm, ccr, best_s, best_slot = carry
            src = (me + s) % n_dev
            lo = (src * s_lists).astype(jnp.int32)
            local_mask = (probes >= lo) & (probes < lo + s_lists)
            pl = jnp.where(local_mask, probes - lo, 0)

            def qchunk(_, ci):
                c0 = ci * chunk
                qq = jax.lax.dynamic_slice_in_dim(q, c0, chunk)
                qqm = jax.lax.dynamic_slice_in_dim(qm, c0, chunk)
                qqr = jax.lax.dynamic_slice_in_dim(qr, c0, chunk)
                pp = jax.lax.dynamic_slice_in_dim(pl, c0, chunk)
                ppm = jax.lax.dynamic_slice_in_dim(local_mask, c0, chunk)
                slabs = cc[pp]            # (chunk, n_probe, lb, D)
                smz = ccm[pp]
                srow = ccr[pp]
                sims = jnp.einsum(
                    "cqd,cpbd->cqpb", qq, slabs.astype(scan_dtype),
                    preferred_element_type=jnp.float32,
                    precision=(jax.lax.Precision.HIGHEST
                               if scan_dtype == jnp.float32 else None),
                )
                diff = qqm[:, :, None, None] - smz[:, None, :, :]
                if tol_is_da:
                    mass_diff = jnp.abs(diff)
                else:
                    mass_diff = jnp.abs(
                        diff / smz[:, None, :, :] * 1e6)
                valid = (
                    (mass_diff <= tol_mass)
                    & jnp.isfinite(smz)[:, None, :, :]
                    & (qqr[:, :, None, None] != srow[:, None, :, :])
                    & ppm[:, None, :, None]
                )
                sims_m = jnp.where(valid, sims, NEG)
                flat = sims_m.reshape(chunk, qlb, n_probe * lb)
                ts, tp = jax.lax.top_k(flat, k_eff)
                p_idx = tp // lb
                b_idx = tp % lb
                probe_of = jnp.take_along_axis(
                    pp[:, None, :].repeat(qlb, axis=1), p_idx, axis=2
                )
                slot = (probe_of + lo) * lb + b_idx
                slot = jnp.where(ts > NEG, slot, -1)
                return 0, (ts, slot)

            _, (ts, slot) = jax.lax.scan(
                qchunk, 0,
                jnp.arange(s_lists // chunk, dtype=jnp.int32),
            )
            ts = ts.reshape(s_lists, qlb, k_eff)
            slot = slot.reshape(s_lists, qlb, k_eff)
            cat_s = jnp.concatenate([best_s, ts], axis=-1)
            cat_slot = jnp.concatenate([best_slot, slot], axis=-1)
            ms, mp = jax.lax.top_k(cat_s, k_eff)
            mslot = jnp.take_along_axis(cat_slot, mp, axis=-1)
            # Rotate the corpus shard: device i's block moves to i-1,
            # so the next step holds block (me + s + 1) % N.
            perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            cc = jax.lax.ppermute(cc, axis, perm)
            ccm = jax.lax.ppermute(ccm, axis, perm)
            ccr = jax.lax.ppermute(ccr, axis, perm)
            return (cc, ccm, ccr, ms, mslot), None

        best_s0 = jnp.full((s_lists, qlb, k_eff), NEG, jnp.float32)
        best_slot0 = jnp.full((s_lists, qlb, k_eff), -1, jnp.int32)
        (_, _, _, best_s, best_slot), _ = jax.lax.scan(
            ring, (c3, cm, cr, best_s0, best_slot0),
            jnp.arange(n_dev, dtype=jnp.int32),
        )
        return best_s, best_slot

    step = jax.jit(jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    ))
    shard = functools.partial(jax.device_put)
    q3d = (index._query3d if index._query3d is not None
           else index._corpus3d)
    scores, slots = step(
        shard(q3d, NamedSharding(mesh, P(axis))),
        shard(index._corpus3d, NamedSharding(mesh, P(axis))),
        shard(index._mz3d, NamedSharding(mesh, P(axis))),
        shard(index._row3d, NamedSharding(mesh, P(axis))),
        shard(jax.numpy.asarray(probe_ids),
              NamedSharding(mesh, P(axis))),
    )

    n = len(index.mzs)
    scores_h = np.array(scores).reshape(n_lists * qlb, -1)
    slots_h = np.asarray(slots).reshape(n_lists * qlb, -1)
    rows_flat = index._row3d_host.reshape(-1)
    neigh_rows = np.where(
        slots_h >= 0,
        rows_flat[np.clip(slots_h, 0, len(rows_flat) - 1)],
        -1,
    ).astype(np.int32)
    out_scores = np.full((n, k_eff), float(NEG), np.float32)
    out_idx = np.full((n, k_eff), -1, np.int32)
    valid = rows_flat >= 0
    out_scores[rows_flat[valid]] = scores_h[valid]
    out_idx[rows_flat[valid]] = neigh_rows[valid]
    if out_scores.shape[1] < k:
        pad = k - out_scores.shape[1]
        out_scores = np.concatenate(
            [out_scores, np.full((n, pad), float(NEG), np.float32)],
            axis=1,
        )
        out_idx = np.concatenate(
            [out_idx, np.full((n, pad), -1, np.int32)], axis=1
        )
    return out_scores, out_idx
