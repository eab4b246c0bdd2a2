"""From-scratch IVF (inverted file) nearest-neighbor index.

Replaces the reference's per-bucket Faiss IVF index (published algorithm,
reference ``README.md:132-142``; Faiss survives in the snapshot only as
dead code, ``falcon/cluster/spectrum.py:5``).  Design:

- **Coarse quantizer**: spherical k-means trained on device — assignment
  is an argmax over ``V @ C.T`` inner products, the update is a
  segment-sum + renormalize.  Seeded and deterministic (SURVEY.md §4:
  the IVF path introduces k-means randomness that must be reproducible).
  Trained on a power-of-two subsample with a power-of-two list count so
  every executable recurs across dataset sizes (the persistent compile
  cache then eliminates the build cost after the first-ever run).
- **3-D list layout**: the corpus lives on device as an
  ``(n_lists, lb, D)`` tensor (every list padded to the same power-of-
  two slab).  Probing list P from list L is then ONE block index — the
  gather moves whole (lb, D) slabs, which is bandwidth-shaped, unlike
  row gathers.
- **Query**: every query in list L probes L's ``n_probe``
  centroid-nearest lists (the quantized-query probe).  The search scans
  CHUNKS of lists; each step block-gathers the chunk's probe slabs and
  runs one big ``einsum`` + fused top-k.  Chunking keeps per-scan-step
  overhead from dominating small steps.

Self-search (the engine's case: queries == corpus) uses the 3-D layout
as the query tensor directly; external queries are assigned, packed
into the same per-list layout (one gather), searched, and unpacked.

Precursor-tolerance masking composes at query time exactly like the
banded brute-force path (``ops/knn.py``).

STATUS: the engine ALWAYS auto-selects the banded scan (``ops/knn.py``)
— bands wider than one column window are covered by merged column
passes in bounded memory, so there is no regime left where
auto-selection prefers this index.  It stays available via
``--ann_index ivf`` as the published-algorithm compatibility surface;
its eps-neighbor recall is below the banded scan's (hashed-embedding
bin splits scatter some eps pairs across lists).  Its speed on the H100
is not measured.

"""

import functools
import logging
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("falcon_tpu")

NEG = jnp.float32(-2.0)


@functools.partial(jax.jit, static_argnames=("n_lists",))
def _kmeans_step(vectors: jnp.ndarray, centroids: jnp.ndarray,
                 n_lists: int) -> jnp.ndarray:
    """One spherical-k-means Lloyd iteration on device."""
    sims = jnp.dot(vectors, centroids.T,
                   preferred_element_type=jnp.float32)
    assign = jnp.argmax(sims, axis=1)
    one_hot = jax.nn.one_hot(assign, n_lists, dtype=jnp.float32)
    sums = jnp.dot(one_hot.T, vectors,
                   preferred_element_type=jnp.float32)
    counts = jnp.sum(one_hot, axis=0)[:, None]
    new = jnp.where(counts > 0, sums, centroids)
    norms = jnp.linalg.norm(new, axis=1, keepdims=True)
    return new / jnp.maximum(norms, 1e-12)


def _kmeans_fit(
    vectors: jnp.ndarray, init: jnp.ndarray, n_lists: int, n_iters: int
) -> jnp.ndarray:
    """Spherical k-means: a Python loop over ONE jitted Lloyd step.

    Deliberately NOT a ``lax.scan``: the single step compiles in seconds
    and is dispatched n_iters times (async, so dispatch latency overlaps
    execution), where the scanned form compiled for minutes on the
    device this code was first built for.
    """
    centroids = init
    for _ in range(n_iters):
        centroids = _kmeans_step(vectors, centroids, n_lists)
    return centroids


@functools.partial(jax.jit, static_argnames=())
def _assign(vectors: jnp.ndarray, centroids: jnp.ndarray) -> jnp.ndarray:
    return jnp.argmax(
        jnp.dot(vectors, centroids.T, preferred_element_type=jnp.float32),
        axis=1,
    )


@functools.partial(jax.jit, static_argnames=("k",))
def _assign_topk(vectors: jnp.ndarray, centroids: jnp.ndarray,
                 k: int) -> jnp.ndarray:
    """Each row's k centroid choices, best first (for balanced spill)."""
    sims = jnp.dot(vectors, centroids.T,
                   preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(sims, k)
    return idx


def _balanced_placement(
    choices: np.ndarray, n_lists: int, cap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-capped list placement, vectorized (no per-row Python
    loop — this sits on the index-build hot path at up to 12.5M rows).

    Rank-by-rank passes: every row first competes (in ascending row
    order) for its best centroid's remaining capacity, unplaced rows
    then compete for their 2nd choice, and so on through the k choices.
    Rows whose every choice is full spill by capacity-only round-robin
    (lists in index order, each taking up to its remaining capacity) —
    such rows lose probe locality, so the spill count is logged as a
    warning (raise n_lists or the choice width if it is large).  Total
    capacity ``n_lists * cap >= 2n`` guarantees the spill always fits.

    Bounds every list at ``cap`` rows, which makes the 3-D slab
    layout's memory DETERMINISTIC (k-means imbalance previously made
    the padded slab width unbounded — a 1M-row corpus OOMed a 16 GB
    chip).  Deterministic given the row order.

    Returns ``(order, counts)``: row indices grouped by list (ascending
    row order within each list) and per-list row counts.
    """
    n, _ = choices.shape
    assigned = np.full(n, -1, np.int64)
    counts = np.zeros(n_lists, np.int64)
    pending = np.arange(n)
    for rank in range(choices.shape[1]):
        if not len(pending):
            break
        want = choices[pending, rank].astype(np.int64)
        by_list = np.argsort(want, kind="stable")
        sw = want[by_list]
        _, start, group_n = np.unique(sw, return_index=True,
                                      return_counts=True)
        # Row's position within its wanted-list group (ascending row
        # order): the first (cap - count) rows of each group fit.
        pos = np.arange(len(sw)) - np.repeat(start, group_n)
        take = pos < (cap - counts[sw])
        assigned[pending[by_list[take]]] = sw[take]
        counts += np.bincount(sw[take], minlength=n_lists)
        pending = pending[assigned[pending] < 0]
    if len(pending):
        logger.warning(
            "IVF balanced placement spilled %d rows whose every "
            "centroid choice was full; spilled rows lose probe "
            "locality (consider more lists)", len(pending),
        )
        slots = np.repeat(np.arange(n_lists), cap - counts)
        spill_to = slots[:len(pending)]
        assigned[pending] = spill_to
        counts += np.bincount(spill_to, minlength=n_lists)
    return np.argsort(assigned, kind="stable"), counts


def _bucket(n: int, minimum: int = 128) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class IVFIndex:
    """IVF index over L2-normalized vectors with precursor metadata."""

    def __init__(
        self,
        vectors,
        precursor_mzs: np.ndarray,
        n_lists: Optional[int] = None,
        n_iters: int = 10,
        seed: int = 42,
        precise: bool = False,
        coarse_vectors=None,
        rank_vectors=None,
    ):
        """``vectors``: (n, D) L2-normalized, NumPy or DEVICE-resident
        (pass the vectorizer's device output — the big matrix then never
        crosses the host boundary: training, list reordering, and
        queries are all device ops).

        ``precise=False`` stores the slab layout in bfloat16 (half the
        HBM; the probe scan runs in bfloat16 anyway when an exact
        rerank re-scores survivors); ``precise=True`` keeps float32
        storage for rerank-free runs.

        ``coarse_vectors``: optional (n, D) L2-normalized embedding used
        ONLY for the coarse quantizer (k-means training, list
        assignment, probe ordering); the in-list scoring still uses
        ``vectors``.  The round-4 root cause of the index's wideband
        recall loss (eps-similar spectra whose fragment bins split
        under m/z jitter land in unrelated lists;
        ``benchmarks/ivf_attrib3.py``) is a property of the PLAIN
        hashed embedding — the tolerance-SPREAD embedding
        (``ops/vectorize.py``: each peak scattered into bins
        {b-1, b, b+1}) guarantees within-tolerance peaks share bins, so
        eps pairs stay coarse-similar and probing finds them.  Not
        retained past __init__ (the extra (n, D) slab would double the
        resident footprint at 2^19-row blocks — measured HBM fatal).

        ``rank_vectors``: optional (n, D) QUERY-side embedding packed
        into a second slab set; self-search then scores
        ``rank_q . vectors_c`` instead of the symmetric inner product.
        Pass the UNNORMALIZED spread embedding with UNNORMALIZED plain
        ``vectors`` and the in-scan ranking becomes the tolerance-spread
        upper bound — the same ranking whose banded exact-top-k has
        measured recall 1.00 — which removes the top-k losses the plain
        hashed cosine causes (scattered eps pairs rank at cos <= 0.43;
        ``benchmarks/ivf_attrib4.py``).  Only meaningful when an exact
        rerank re-scores the survivors (the returned similarities are
        then bounds, not cosines).
        """
        # ``vectors`` may carry padded zero rows past len(precursor_mzs)
        # (the engines keep device arrays at power-of-two row counts);
        # only the first n rows are indexed.
        n = len(precursor_mzs)
        if n_lists is None:
            n_lists = _bucket(max(1, int(np.sqrt(n) + 0.5)), 16)
        # The chunked probe scan requires chunk | n_lists with a
        # power-of-two chunk, so force the list count to a power of two
        # (round DOWN so it never exceeds n).
        self.n_lists = 1 << max(0, int(min(n_lists, n)).bit_length() - 1)
        rng = np.random.default_rng(seed)
        if isinstance(vectors, np.ndarray):
            vectors_dev = jax.device_put(
                np.ascontiguousarray(vectors, dtype=np.float32)
            )
        else:
            vectors_dev = vectors
        if coarse_vectors is None:
            coarse_dev = vectors_dev
        elif isinstance(coarse_vectors, np.ndarray):
            coarse_dev = jax.device_put(
                np.ascontiguousarray(coarse_vectors, dtype=np.float32)
            )
        else:
            coarse_dev = coarse_vectors
        self._coarse = coarse_vectors is not None
        # Train the quantizer on a power-of-two subsample (Faiss trains
        # on ~a few hundred points per centroid; more adds cost, not
        # quality) so the training shape is size-class stable too.
        sample = min(_bucket(self.n_lists * 128, 1024),
                     _bucket(n, 512))
        train_rows = (np.arange(sample) * max(n // sample, 1)) % n
        init_rows = rng.choice(n, self.n_lists, replace=False)
        train = coarse_dev[jnp.asarray(train_rows.astype(np.int32))]
        init = coarse_dev[jnp.asarray(init_rows.astype(np.int32))]
        raw_centroids = np.asarray(_kmeans_fit(
            train, init, self.n_lists, n_iters
        ))
        self.centroids = raw_centroids
        # Only the n x 4 int32 centroid choices cross to the host.
        choices = np.asarray(_assign_topk(
            coarse_dev, jnp.asarray(raw_centroids),
            min(8, self.n_lists),
        ))[:n]
        del coarse_dev  # see docstring: never resident past init
        # Capacity-capped balanced placement: the cap (2x the mean list
        # size, pow2-bucketed) makes the padded slab width — and hence
        # the layout's HBM footprint — deterministic.  Overflow rows
        # fall through their 8 nearest centroids' lists; rows whose
        # every choice is full spill capacity-round-robin (logged —
        # they lose probe locality, see _balanced_placement).
        cap = _bucket(2 * max(1, -(-n // self.n_lists)), 128)
        self.order, counts = _balanced_placement(
            choices, self.n_lists, cap)
        # Probe-ordering note (round-4 measurement,
        # benchmarks/ivf_attrib3.py): on the wideband corpus ~97% of
        # the index's eps-relevant recall misses are PROBE misses, with
        # the true neighbor's list at median rank ~117/256 in this
        # centroid-similarity probe order — i.e. near-random.  A
        # member-aware ordering (rank lists by how many of a list's
        # members name them among their own top-8 centroid choices) was
        # implemented and MEASURED NO BETTER (eps recall 0.713 vs
        # 0.721 at n_probe=32), because the hashed embedding itself
        # scatters eps-similar spectra across unrelated centroids
        # (fragment-bin splits under m/z jitter).  The production
        # answer to that regime is the column-streamed banded scan
        # (ops/knn.py), which is exact within the band; this index
        # stays available via --ann_index ivf with its measured recall
        # documented in README "Index selection".
        self.mzs = np.asarray(precursor_mzs, np.float64)[self.order]
        self.rows = self.order.astype(np.int32)
        self.offsets = np.zeros(self.n_lists + 1, np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self._max_list = int(counts.max(initial=1))
        # 3-D (n_lists, lb, D) layout; probing moves whole (lb, D)
        # blocks.  Built by CHUNKED gathers (a single full-size gather
        # materializes source + output simultaneously — at 1M x 512
        # that alone exceeded HBM) and stored in bfloat16 unless
        # ``precise`` (the scan computes in bfloat16 anyway when an
        # exact rerank follows).
        self._lb = _bucket(self._max_list, 128)
        idx3d, mz3d, row3d = self._pack_layout(
            self.order, self.mzs, counts, self._lb, n)
        dim = int(vectors_dev.shape[1])
        store_dtype = jnp.float32 if precise else jnp.bfloat16
        mask = (mz3d < np.inf).astype(np.float32)
        lists_per_chunk = max(1, (2 ** 28) // (self._lb * dim * 4))
        parts = []
        for c0 in range(0, self.n_lists, lists_per_chunk):
            c1 = min(c0 + lists_per_chunk, self.n_lists)
            idx = jnp.asarray(idx3d[c0 * self._lb:c1 * self._lb])
            part = vectors_dev[idx].reshape(c1 - c0, self._lb, dim)
            # Padding slots alias row order[0] via the clipped gather;
            # zero them (their m/z is +inf so they are masked anyway).
            part = part * jnp.asarray(mask[c0:c1]).reshape(
                c1 - c0, self._lb, 1)
            parts.append(part.astype(store_dtype))
        self._corpus3d = (parts[0] if len(parts) == 1
                          else jnp.concatenate(parts))
        self._query3d = None
        if rank_vectors is not None:
            if isinstance(rank_vectors, np.ndarray):
                rank_dev = jax.device_put(
                    np.ascontiguousarray(rank_vectors, dtype=np.float32)
                )
            else:
                rank_dev = rank_vectors
            qparts = []
            for c0 in range(0, self.n_lists, lists_per_chunk):
                c1 = min(c0 + lists_per_chunk, self.n_lists)
                idx = jnp.asarray(idx3d[c0 * self._lb:c1 * self._lb])
                part = rank_dev[idx].reshape(c1 - c0, self._lb, dim)
                part = part * jnp.asarray(mask[c0:c1]).reshape(
                    c1 - c0, self._lb, 1)
                qparts.append(part.astype(store_dtype))
            self._query3d = (qparts[0] if len(qparts) == 1
                             else jnp.concatenate(qparts))
            del rank_dev
        self._mz3d = jnp.asarray(mz3d.reshape(self.n_lists, self._lb))
        self._row3d_host = row3d.reshape(self.n_lists, self._lb)
        self._row3d = jnp.asarray(self._row3d_host)
        self._source = vectors_dev  # identity marker for self-search
        self._centroid_sims = self.centroids @ self.centroids.T
        self._probe_cache = {}

    @staticmethod
    def _pack_layout(order, mzs_sorted, counts, lb, n):
        """Host index/metadata arrays for the (n_lists, lb) layout."""
        n_lists = len(counts)
        idx3d = np.zeros((n_lists, lb), np.int32)
        mz3d = np.full((n_lists, lb), np.inf, np.float32)
        row3d = np.full((n_lists, lb), -1, np.int32)
        offsets = np.zeros(n_lists + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        for lst in range(n_lists):
            c = int(counts[lst])
            lo = int(offsets[lst])
            idx3d[lst, :c] = order[lo:lo + c]
            mz3d[lst, :c] = mzs_sorted[lo:lo + c]
            row3d[lst, :c] = order[lo:lo + c]
        return idx3d.reshape(-1), mz3d, row3d

    def _probe_ids(self, n_probe: int) -> np.ndarray:
        cached = self._probe_cache.get(n_probe)
        if cached is None:
            cached = np.ascontiguousarray(np.argsort(
                -self._centroid_sims, axis=1, kind="stable"
            )[:, :n_probe].astype(np.int32))
            self._probe_cache[n_probe] = cached
        return cached

    def search(
        self,
        q_vec: np.ndarray,
        q_mz: np.ndarray,
        q_rows: np.ndarray,
        k: int,
        n_probe: int = 32,
        tol_mass: float = np.inf,
        tol_mode: str = "Da",
        per_list_k: Optional[int] = None,
        precise: bool = False,
        q_coarse=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN of each query; returns (similarities, original row ids).

        Missing neighbors: sim -2, id -1.  ``per_list_k`` is accepted
        for API compatibility and ignored (the chunked einsum merges
        every probed candidate).  ``precise`` keeps the probe-scan
        einsum in float32 — use it when NO exact rerank runs downstream,
        so eps-threshold comparisons see full-precision similarities
        (bfloat16's ~2-3 significant digits would shift membership near
        the threshold; advisor round-2 finding).

        ``q_coarse``: (nq, D) coarse-space query vectors, required for
        NON-self searches against an index built with
        ``coarse_vectors`` (query assignment must happen in the same
        embedding the quantizer was trained in); self-searches reuse
        the build-time assignments and ignore it.
        """
        nq = len(q_mz)
        n = len(self.mzs)
        n_probe = min(n_probe, self.n_lists)
        tol_is_da = tol_mode == "Da"
        lb = self._lb
        probe_ids = self._probe_ids(n_probe)

        self_search = q_vec is self._source and nq == n
        if self_search:
            q3d = (self._query3d if self._query3d is not None
                   else self._corpus3d)
            qmz3d, qrow3d = self._mz3d, self._row3d
            qlb = lb
        else:
            if isinstance(q_vec, np.ndarray):
                q_vec_dev = jax.device_put(
                    np.ascontiguousarray(q_vec, np.float32))
            else:
                q_vec_dev = q_vec
            if self._coarse and q_coarse is None:
                logger.warning(
                    "IVF index built on a coarse embedding but the "
                    "query passed none; assigning queries with the "
                    "scoring embedding (degraded probe locality)"
                )
            q_assign_src = q_vec_dev
            if q_coarse is not None:
                if isinstance(q_coarse, np.ndarray):
                    q_assign_src = jax.device_put(
                        np.ascontiguousarray(q_coarse, np.float32))
                else:
                    q_assign_src = q_coarse
            q_assign = np.asarray(
                _assign(q_assign_src, jnp.asarray(self.centroids)))[:nq]
            q_order = np.argsort(q_assign, kind="stable")
            q_counts = np.bincount(q_assign, minlength=self.n_lists)
            qlb = _bucket(int(q_counts.max(initial=1)), 128)
            idx3d, qmz3, qrow3 = self._pack_layout(
                q_order,
                np.asarray(q_mz, np.float64)[q_order],
                q_counts, qlb, nq,
            )
            # Query "row ids" in the layout carry the CALLER's row ids
            # (used for self-pair exclusion when queries overlap the
            # corpus by id).
            qrow3 = np.where(
                qrow3 >= 0,
                np.asarray(q_rows, np.int32)[np.clip(qrow3, 0, nq - 1)],
                -2,
            ).astype(np.int32)
            q3d = q_vec_dev[jnp.asarray(idx3d)].reshape(
                self.n_lists, qlb, -1)
            q3d = q3d * jnp.asarray(
                (qmz3 < np.inf).astype(np.float32)
            ).reshape(self.n_lists, qlb, 1)
            qmz3d = jnp.asarray(qmz3.reshape(self.n_lists, qlb))
            qrow3d = jnp.asarray(qrow3.reshape(self.n_lists, qlb))
            q_slot_pos = np.full(self.n_lists * qlb, -1, np.int64)
            # Map layout slots back to sorted query positions.
            pos = 0
            for lst in range(self.n_lists):
                c = int(q_counts[lst])
                base = lst * qlb
                q_slot_pos[base:base + c] = np.arange(pos, pos + c)
                pos += c

        # Chunk size: bound the (chunk, qlb, n_probe, lb) f32 score
        # intermediate to ~256 MB.
        chunk = 1
        while (chunk * 2 * qlb * n_probe * lb * 4 <= 256 * 2**20
               and chunk * 2 <= self.n_lists):
            chunk *= 2
        k_eff = min(k if self_search else k + 1, n_probe * lb)

        import os as _os

        exact_topk = _os.environ.get(
            "FALCON_TPU_IVF_EXACT_TOPK", "1") != "0"
        scores, slots = _chunk_scan(
            q3d, qmz3d, qrow3d,
            self._corpus3d, self._mz3d, self._row3d,
            jnp.asarray(probe_ids),
            jnp.float32(tol_mass),
            k_eff, tol_is_da, int(chunk), int(qlb), int(lb),
            int(n_probe), bool(precise), exact_topk,
        )
        scores_h = np.array(scores.reshape(self.n_lists * qlb, -1))
        slots_h = np.asarray(slots).reshape(self.n_lists * qlb, -1)
        rows_flat = self._row3d_host.reshape(-1)
        neigh_rows = np.where(
            slots_h >= 0,
            rows_flat[np.clip(slots_h, 0, len(rows_flat) - 1)],
            -1,
        ).astype(np.int32)

        out_scores = np.full((nq, k_eff), float(NEG), np.float32)
        out_idx = np.full((nq, k_eff), -1, np.int32)
        if self_search:
            valid = rows_flat >= 0
            out_scores[rows_flat[valid]] = scores_h[valid]
            out_idx[rows_flat[valid]] = neigh_rows[valid]
        else:
            valid = q_slot_pos >= 0
            sorted_scores = np.full((nq, k_eff), float(NEG), np.float32)
            sorted_rows = np.full((nq, k_eff), -1, np.int32)
            sorted_scores[q_slot_pos[valid]] = scores_h[valid]
            sorted_rows[q_slot_pos[valid]] = neigh_rows[valid]
            # Remove self matches by row id, re-compact, trim to k.
            bad = sorted_rows == np.asarray(q_rows, np.int32)[q_order][
                :, None]
            sorted_scores[bad] = float(NEG)
            sorted_rows[bad] = -1
            order2 = np.argsort(-sorted_scores, axis=1, kind="stable")
            sorted_scores = np.take_along_axis(sorted_scores, order2, 1)
            sorted_rows = np.take_along_axis(sorted_rows, order2, 1)
            k_eff = min(k, k_eff)
            out_scores = np.full((nq, k_eff), float(NEG), np.float32)
            out_idx = np.full((nq, k_eff), -1, np.int32)
            out_scores[q_order] = sorted_scores[:, :k_eff]
            out_idx[q_order] = sorted_rows[:, :k_eff]
        if out_scores.shape[1] < k:
            pad = k - out_scores.shape[1]
            out_scores = np.concatenate(
                [out_scores, np.full((nq, pad), float(NEG), np.float32)],
                axis=1,
            )
            out_idx = np.concatenate(
                [out_idx, np.full((nq, pad), -1, np.int32)], axis=1
            )
        return out_scores, out_idx


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "tol_is_da", "chunk", "qlb", "lb", "n_probe", "precise",
        "exact_topk",
    ),
)
def _chunk_scan(
    q3d,        # (n_lists, qlb, D) per-list query tensor
    qmz3d,      # (n_lists, qlb) +inf padding
    qrow3d,     # (n_lists, qlb) original row ids, negative padding
    corpus3d,   # (n_lists, lb, D)
    cmz3d,
    crow3d,
    probe_ids,  # (n_lists, n_probe)
    tol_mass,
    k: int,
    tol_is_da: bool,
    chunk: int,
    qlb: int,
    lb: int,
    n_probe: int,
    precise: bool = False,
    exact_topk: bool = True,
):
    """Chunked probe scan: per step, block-gather the chunk's probe
    slabs and run one einsum + fused top-k.  Returns (scores, SLOT ids
    into the flattened (n_lists * lb) layout; -1 missing).

    ``precise=False`` scans in bfloat16 (half the memory traffic; fine
    when an exact rerank re-scores survivors); ``precise=True`` keeps float32 so the
    ranking similarities are directly threshold-comparable.
    """
    n_lists = corpus3d.shape[0]
    scan_dtype = jnp.float32 if precise else jnp.bfloat16
    c16 = corpus3d.astype(scan_dtype)
    q16 = q3d.astype(scan_dtype)
    n_chunks = n_lists // chunk

    def step(_, ci):
        c0 = ci * chunk
        q = jax.lax.dynamic_slice_in_dim(q16, c0, chunk)
        qm = jax.lax.dynamic_slice_in_dim(qmz3d, c0, chunk)
        qr = jax.lax.dynamic_slice_in_dim(qrow3d, c0, chunk)
        probes = jax.lax.dynamic_slice_in_dim(probe_ids, c0, chunk)
        slabs = c16[probes]          # (chunk, n_probe, lb, D)
        smz = cmz3d[probes]          # (chunk, n_probe, lb)
        srow = crow3d[probes]
        sims = jnp.einsum(
            "cqd,cpbd->cqpb", q, slabs,
            preferred_element_type=jnp.float32,
            # precise: eps-threshold consumers need f32, not TF32.
            precision=jax.lax.Precision.HIGHEST if precise else None,
        )
        diff = qm[:, :, None, None] - smz[:, None, :, :]
        if tol_is_da:
            mass_diff = jnp.abs(diff)
        else:
            mass_diff = jnp.abs(diff / smz[:, None, :, :] * 1e6)
        valid = (
            (mass_diff <= tol_mass)
            & jnp.isfinite(smz)[:, None, :, :]
            & (qr[:, :, None, None] != srow[:, None, :, :])
        )
        sims = jnp.where(valid, sims, NEG)
        flat = sims.reshape(chunk, qlb, n_probe * lb)
        if exact_topk:
            # approx_max_k's recall_target=0.99 was MEASURED as the
            # single largest IVF recall loss (benchmarks/ivf_attrib.py,
            # round-3 verdict #2); the exact top-k costs a few percent
            # of scan time and removes it entirely.
            top_scores, top_pos = jax.lax.top_k(flat, k)
        else:
            top_scores, top_pos = jax.lax.approx_max_k(
                flat, k, recall_target=0.99
            )
        p_idx = top_pos // lb
        b_idx = top_pos % lb
        probe_of = jnp.take_along_axis(
            probes[:, None, :].repeat(qlb, axis=1), p_idx, axis=2
        )
        slot = probe_of * lb + b_idx
        slot = jnp.where(top_scores > NEG, slot, -1)
        return 0, (top_scores, slot)

    _, (scores, slots) = jax.lax.scan(
        step, 0, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return (scores.reshape(n_lists, qlb, k),
            slots.reshape(n_lists, qlb, k))
