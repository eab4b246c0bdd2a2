"""On-device consensus spectrum construction.

The reference exports the *medoid* spectrum per cluster
(``falcon/cluster/cluster.py:512-553``, ``falcon/falcon.py:198-203``);
falcon-tpu additionally builds *consensus* spectra (BASELINE.json config
#4): all member peaks of a cluster are discretized to ``fragment_tol``
bins, bins supported by at least ``min_fraction`` of the cluster's
members survive, and each surviving bin becomes one consensus peak at
the intensity-weighted mean m/z with the member-averaged intensity
(L2-renormalized, capped at ``max_peaks``).

Device plan: the whole aggregation for a charge bucket is ONE jitted
dispatch — a multi-key ``lax.sort`` over (cluster*n_bins + bin, member)
composite keys followed by run-boundary detection and scatter-add
segment sums.  The host only reshapes the compact per-bin table into
ragged per-cluster peak lists.
"""

from typing import Dict, Optional, Tuple

import numpy as np


_aggregate_jit = None


def _get_aggregate():
    global _aggregate_jit
    if _aggregate_jit is not None:
        return _aggregate_jit
    import jax
    import jax.numpy as jnp

    @jax.jit
    def aggregate(bin_key, member, mz, intensity):
        """Sort peaks by (cluster-bin key, member) and reduce per key.

        Inputs are flat (n_peaks_padded,) arrays; padding peaks carry
        ``bin_key = int64 max`` so they sort to the end and fall into
        trailing segments the host ignores.

        Returns per-peak-slot segment tables (same length): for each
        distinct key, at its first slot: the key, total intensity,
        intensity-weighted m/z sum, and the number of distinct members
        contributing; plus the total number of distinct keys.
        """
        bin_key, member, mz, intensity = jax.lax.sort(
            (bin_key, member, mz, intensity), num_keys=2
        )
        first = jnp.concatenate(
            [jnp.ones(1, bool), bin_key[1:] != bin_key[:-1]]
        )
        # Distinct (key, member) pairs mark one member contribution.
        member_new = jnp.concatenate(
            [jnp.ones(1, bool),
             (bin_key[1:] != bin_key[:-1]) | (member[1:] != member[:-1])]
        )
        seg = jnp.cumsum(first) - 1  # segment id per sorted peak
        n = bin_key.shape[0]
        int_sum = jnp.zeros(n, jnp.float32).at[seg].add(intensity)
        mzint_sum = jnp.zeros(n, jnp.float32).at[seg].add(mz * intensity)
        members = jnp.zeros(n, jnp.int32).at[seg].add(
            member_new.astype(jnp.int32)
        )
        keys = jnp.zeros(n, bin_key.dtype).at[seg].max(bin_key)
        n_keys = seg[-1] + 1
        return keys, int_sum, mzint_sum, members, n_keys

    _aggregate_jit = aggregate
    return aggregate


def consensus_spectra(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    intensity_flat: np.ndarray,
    labels: np.ndarray,
    fragment_tol: float,
    min_mz: float,
    min_fraction: float = 0.5,
    max_peaks: Optional[int] = 50,
    cluster_filter: Optional[np.ndarray] = None,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Consensus peaks per cluster label.

    ``offsets``/``mz_flat``/``intensity_flat``: the ragged peak arrays of
    one charge dataset (store layout).  ``labels``: per-row cluster label
    (dataset row order); labels must be NON-NEGATIVE — the engines
    promote noise (-1) to singleton labels before this runs.  Returns {label: (mz, intensity)} with intensity
    L2-normalized, for the labels in ``cluster_filter`` (default: all).

    Single-member clusters pass their (already preprocessed) spectrum
    through unchanged.
    """
    import jax.numpy as jnp

    labels = np.asarray(labels)
    n_rows = len(labels)
    lengths = np.diff(offsets).astype(np.int64)
    if cluster_filter is not None:
        keep_label = np.zeros(int(labels.max()) + 1, bool)
        keep_label[np.asarray(cluster_filter, np.int64)] = True
        row_mask = keep_label[labels]
    else:
        row_mask = np.ones(n_rows, bool)

    sizes = np.bincount(labels[row_mask],
                        minlength=int(labels.max()) + 1)

    flat_mask = np.repeat(row_mask, lengths)
    mz = np.asarray(mz_flat, np.float32)[flat_mask]
    intensity = np.asarray(intensity_flat, np.float32)[flat_mask]
    peak_labels = np.repeat(labels[row_mask].astype(np.int64),
                            lengths[row_mask])
    peak_member = np.repeat(
        np.arange(n_rows, dtype=np.int32)[row_mask], lengths[row_mask]
    )
    n_peaks = len(mz)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    if n_peaks == 0:
        return out

    bins = np.floor((mz.astype(np.float64) - min_mz) / fragment_tol)
    bins = np.maximum(bins, 0).astype(np.int64)
    n_bins = int(bins.max()) + 1

    # JAX defaults to 32-bit integers, so the (cluster, bin) composite key
    # is built per label-range chunk such that chunk_size * n_bins stays
    # below int32 max (one dispatch for any realistic charge bucket).
    big = np.int32(2**31 - 1)
    labels_per_chunk = max((2**31 - 2) // n_bins, 1)
    max_label = int(peak_labels.max())
    parts = []
    for base in range(0, max_label + 1, labels_per_chunk):
        chunk_mask = ((peak_labels >= base)
                      & (peak_labels < base + labels_per_chunk))
        if not chunk_mask.any():
            continue
        key32 = ((peak_labels[chunk_mask] - base) * n_bins
                 + bins[chunk_mask]).astype(np.int32)
        m_chunk = peak_member[chunk_mask]
        mz_chunk = mz[chunk_mask]
        int_chunk = intensity[chunk_mask]
        # Pad to a power-of-two bucket (stable compiled shapes).
        n_pad = 1024
        while n_pad < len(key32):
            n_pad *= 2
        pad = n_pad - len(key32)
        keys, int_sum, mzint_sum, members, n_keys = _get_aggregate()(
            jnp.asarray(np.concatenate(
                [key32, np.full(pad, big, np.int32)])),
            jnp.asarray(np.concatenate(
                [m_chunk, np.zeros(pad, np.int32)])),
            jnp.asarray(np.concatenate(
                [mz_chunk, np.zeros(pad, np.float32)])),
            jnp.asarray(np.concatenate(
                [int_chunk, np.zeros(pad, np.float32)])),
        )
        n_keys = int(n_keys)
        keys = np.asarray(keys)[:n_keys]
        real = keys < big
        parts.append((
            base + (keys[real] // n_bins).astype(np.int64),
            keys[real] % n_bins,
            np.asarray(int_sum)[:n_keys][real],
            np.asarray(mzint_sum)[:n_keys][real],
            np.asarray(members)[:n_keys][real],
        ))
    bin_cluster = np.concatenate([p[0] for p in parts])
    int_sum = np.concatenate([p[2] for p in parts])
    mzint_sum = np.concatenate([p[3] for p in parts])
    members = np.concatenate([p[4] for p in parts])
    mz_mean = mzint_sum / np.maximum(int_sum, 1e-12)
    int_mean = int_sum / np.maximum(members, 1)

    # Per cluster: keep bins supported by >= min_fraction of members,
    # cap at max_peaks most intense, sort by m/z, L2-normalize.
    order = np.argsort(bin_cluster, kind="stable")
    bounds = np.flatnonzero(
        np.diff(bin_cluster[order], prepend=-1, append=-1)
    )
    for s, e in zip(bounds[:-1], bounds[1:]):
        idx = order[s:e]
        label = int(bin_cluster[idx[0]])
        size = int(sizes[label])
        need = max(int(np.ceil(min_fraction * size)), 1)
        keep = members[idx] >= need
        if not keep.any():
            # Degenerate (no bin reaches quorum): fall back to the single
            # best-supported bin so every cluster exports something.
            keep = members[idx] == members[idx].max()
        sel = idx[keep]
        if max_peaks is not None and len(sel) > max_peaks:
            top = np.argsort(int_mean[sel], kind="stable")[-max_peaks:]
            sel = sel[top]
        mz_sel = mz_mean[sel]
        int_sel = int_mean[sel]
        mz_order = np.argsort(mz_sel, kind="stable")
        mz_sel, int_sel = mz_sel[mz_order], int_sel[mz_order]
        norm = np.linalg.norm(int_sel)
        out[label] = (
            mz_sel.astype(np.float32),
            (int_sel / max(norm, 1e-12)).astype(np.float32),
        )
    return out
