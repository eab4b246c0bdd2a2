"""Per-charge clustering engine (exact backend).

Reproduces the observable behavior of the reference's
``cluster.generate_clusters`` (``falcon/cluster/cluster.py:24-156``) and
``_cluster_interval`` (``cluster.py:212-331``) with a device execution
plan:

- the all-pairs peak-matching cosine distance matrix of each precursor-m/z
  interval is computed on device by the pair-panel scorer
  (``ops/pairwise.py``) instead of one CPython thread future per pair;
- hierarchical linkage + the distance cut run in the first-party native
  library (``native/falcon_native.cc``) instead of fastcluster/scipy;
- precursor-m/z / RT splitting, medoids, and global label assignment are
  vectorized NumPy (``cluster/postprocess.py``).

Device and host work are pipelined: while the host clusters interval k,
the device already computes distances for interval k+1.

Documented divergences from the reference (SURVEY.md §3.5): medoids are
always dataset row indices (the reference returns interval *positions*
when an interval yields no clusters, which would make ``dataset.take``
fetch wrong rows); the trailing m/z block is chunked to ``batch_size``
like every other block; the mz x RT label merge uses a true pairing.
"""

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from .. import native
from ..ops import pairwise
from ..store.store import ChargeDataset, padded_peaks
from .intervals import precursor_mz_splits
from .postprocess import (
    assign_global_cluster_labels,
    cluster_group_slices,
    cluster_medoids,
    postprocess_cluster,
)

logger = logging.getLogger("falcon_tpu")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def generate_clusters(
    dataset: ChargeDataset,
    linkage: str,
    distance_threshold: float,
    min_matches: int,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
    fragment_tol: float,
    batch_size: int,
    max_peaks: int = 50,
    backend: Optional[str] = None,
    rounds: Optional[int] = None,
    devices: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one charge bucket; returns (labels, medoid row indices).

    Labels are globally unique within the bucket; every spectrum gets a
    label (noise points become singleton clusters, reference
    ``cluster.py:144-155``).
    """
    meta = dataset.read_metadata(
        columns=("precursor_mz", "retention_time")
    )
    offsets, mz_flat, int_flat = dataset.read_peaks()
    n = len(meta["precursor_mz"])
    precursor_mzs = np.asarray(meta["precursor_mz"], np.float64)
    rts = np.asarray(meta["retention_time"], np.float64)

    order = np.argsort(precursor_mzs, kind="stable")
    mz_sorted = precursor_mzs[order]
    rt_sorted = rts[order]

    splits = precursor_mz_splits(
        mz_sorted, precursor_tol_mass, precursor_tol_mode, batch_size
    )
    logger.info(
        "Cluster %d spectra using %s linkage and distance threshold %.3f "
        "(%d precursor m/z intervals)",
        n, linkage, distance_threshold, len(splits) - 1,
    )

    labels = np.full(n, -1, np.int32)
    pad_to = _round_up(max(max_peaks, 1), 64)
    n_intervals = len(splits) - 1
    sizes = np.diff(splits)

    # Device scheduling: hundreds of small intervals are batched into
    # size-class groups and scored in a handful of dispatches
    # (pairwise.grouped_condensed_distances) — per-dispatch latency, not
    # FLOPs, dominates small intervals.  Large intervals stream row
    # panels over their upper triangle individually.  Both use the same
    # pair-panel scorer (``backend`` as in pairwise.panel_scores).  A
    # producer thread owns all device work and overlaps it with
    # host-side linkage/postprocessing.
    GROUP_MAX = 1024
    small = [k for k in range(n_intervals)
             if 2 <= sizes[k] <= GROUP_MAX]
    large = [k for k in range(n_intervals) if sizes[k] > GROUP_MAX]

    def interval_peaks(k: int):
        rows = order[splits[k]:splits[k + 1]]
        mz_pad, int_pad, _ = padded_peaks(
            offsets, mz_flat, int_flat, pad_to, rows
        )
        return mz_pad, int_pad

    results: dict = {}
    results_lock = threading.Lock()
    results_ready = threading.Condition(results_lock)
    kwargs = {} if rounds is None else {"rounds": rounds}
    # Producer backpressure: condensed pdists are ~2.1 GB float32 at the
    # default 2^15 interval cap, so an unthrottled producer could pile
    # several of them up whenever the device outruns host linkage.  The
    # producer only waits while the consumer can progress WITHOUT it
    # (its needed interval is buffered) — produce order and consume
    # order differ (small group before large), so a plain size bound
    # would deadlock.
    buffer_cap = int(os.environ.get(
        "FALCON_TPU_EXACT_BUFFER_BYTES", 3 * 2**30))
    state = {"need": 0, "stop": False, "bytes": 0}

    def put(k: int, pdist: Optional[np.ndarray]) -> None:
        with results_ready:
            results[k] = pdist
            if pdist is not None:
                state["bytes"] += pdist.nbytes
            results_ready.notify_all()
            while (not state["stop"]
                   and state["bytes"] > buffer_cap
                   and state["need"] in results):
                results_ready.wait()

    # Multi-chip: large intervals' condensed pair lists are sharded over
    # the mesh (parallel/sharded_exact.py) — each unordered pair scored
    # once, equal per-device pair counts, same condensed output.
    mesh = None
    if devices is not None and devices > 1 and large:
        import jax

        if len(jax.devices()) >= devices:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(devices)
        else:
            logger.warning(
                "Requested %d devices but only %d visible; exact panel "
                "scoring stays single-device", devices, len(jax.devices()),
            )

    def producer() -> None:
        try:
            if small:
                gen = pairwise.grouped_condensed_distances(
                    [interval_peaks(k) for k in small],
                    fragment_tol, min_matches, backend=backend, **kwargs,
                )
                for local_i, pdist in gen:
                    if state["stop"]:  # consumer failed: abort promptly
                        return
                    put(small[local_i], pdist)
            for k in large:
                if state["stop"]:
                    return
                mz_pad, int_pad = interval_peaks(k)
                if mesh is not None:
                    from ..parallel.sharded_exact import (
                        condensed_distances_sharded)

                    pdist = condensed_distances_sharded(
                        mz_pad, int_pad, fragment_tol, min_matches,
                        mesh, **kwargs,
                    )
                    if pdist is not None:  # None: too large for int32
                        put(k, pdist)
                        continue
                put(k, pairwise.condensed_distances(
                    mz_pad, int_pad, fragment_tol, min_matches,
                    backend=backend, **kwargs,
                ))
        except BaseException as e:  # propagate to the consumer
            with results_ready:
                results["error"] = e
                results_ready.notify_all()

    # Progress over spectra clustered (reference cluster.py:101-103 shows
    # a tqdm bar; disabled automatically on non-tty stderr).
    try:
        from tqdm import tqdm

        progress = tqdm(
            total=n, desc="Clustering", unit="spectra", smoothing=0.1,
            disable=None,
        )
    except ImportError:  # pragma: no cover
        progress = None

    medoids = []
    with ThreadPoolExecutor(max_workers=1) as device_pool:
        device_pool.submit(producer)
        try:
            for k in range(n_intervals):
                if sizes[k] <= 1:
                    pdist = None
                else:
                    with results_ready:
                        state["need"] = k
                        results_ready.notify_all()  # producer re-checks
                        while k not in results and "error" not in results:
                            results_ready.wait()
                        if "error" in results and k not in results:
                            raise results["error"]
                        pdist = results.pop(k)
                        if pdist is not None:
                            state["bytes"] -= pdist.nbytes
                        results_ready.notify_all()
                start, stop = splits[k], splits[k + 1]
                interval_medoids = _cluster_interval(
                    labels, order, mz_sorted, rt_sorted, pdist,
                    int(start), int(stop), linkage, distance_threshold,
                    precursor_tol_mass, precursor_tol_mode, rt_tol,
                )
                medoids.append(interval_medoids)
                if progress is not None:
                    progress.update(int(stop - start))
        finally:
            # Unstick a back-pressured producer so the pool join above
            # cannot deadlock when the consumer raises.
            with results_ready:
                state["stop"] = True
                results_ready.notify_all()
    if progress is not None:
        progress.close()

    max_label = assign_global_cluster_labels(labels, order, splits, 0)
    del max_label
    medoids = (np.hstack(medoids) if medoids
               else np.zeros(0, np.int64))
    noise_mask = labels == -1
    n_clusters = int(labels.max()) + 1 if n else 0
    n_noise = int(noise_mask.sum())
    logger.info(
        "%d spectra grouped in %d clusters, %d spectra remain as "
        "singletons",
        int((~noise_mask).sum()), n_clusters, n_noise,
    )
    # Reassign noise points to singleton clusters.
    labels[noise_mask] = np.arange(
        n_clusters, n_clusters + n_noise, dtype=np.int32
    )
    return labels, medoids


def _cluster_interval(
    labels: np.ndarray,
    order: np.ndarray,
    mz_sorted: np.ndarray,
    rt_sorted: np.ndarray,
    pdist: Optional[np.ndarray],
    interval_start: int,
    interval_stop: int,
    linkage: str,
    distance_threshold: float,
    precursor_tol_mass: float,
    precursor_tol_mode: str,
    rt_tol: Optional[float],
) -> np.ndarray:
    """Cluster one precursor-m/z interval; returns medoid row indices."""
    n_vectors = interval_stop - interval_start
    rows = order[interval_start:interval_stop]
    if n_vectors <= 1:
        # Too small to cluster; the point stays noise and represents
        # itself (divergence: dataset row index, not interval position).
        return rows.astype(np.int64)

    # No astype here: native.linkage makes exactly one f64 working copy
    # itself (native.py); a pre-conversion would add a second multi-GB
    # temp at the 2^15 interval cap.
    z = native.linkage(pdist, linkage)
    flat = native.fcluster(z, distance_threshold, n=n_vectors)

    order1 = np.argsort(flat, kind="stable")
    idx_interval = rows[order1]
    mzs_interval = mz_sorted[interval_start:interval_stop][order1]
    rts_interval = rt_sorted[interval_start:interval_stop][order1]
    sorted_labels = flat[order1].astype(np.int32)

    current_label = 0
    for start_i, stop_i in list(cluster_group_slices(sorted_labels)):
        n_clusters = postprocess_cluster(
            sorted_labels[start_i:stop_i],
            mzs_interval[start_i:stop_i],
            rts_interval[start_i:stop_i],
            precursor_tol_mass,
            precursor_tol_mode,
            rt_tol,
            2,
            current_label,
        )
        current_label += n_clusters

    labels[idx_interval] = sorted_labels

    if current_label > 0:
        order2 = np.argsort(sorted_labels, kind="stable")
        return cluster_medoids(
            idx_interval[order2],
            sorted_labels[order2],
            pdist,
            order1[order2],
        )
    # No clusters: every point represents itself.
    return idx_interval.astype(np.int64)
