"""Banded k-nearest-neighbor search over hashed spectrum vectors.

The published falcon algorithm finds each spectrum's nearest neighbors
among spectra within the precursor m/z tolerance (reference
``README.md:132-142``; per-bucket Faiss IVF indexes).  Device design:
spectra are already sorted by precursor m/z, so the tolerance constraint
makes the candidate set a contiguous *band* around the diagonal — k-NN
becomes banded blocked matmuls with a fused top-k; bands
beyond one window are covered with merged column passes (no
inverted-index switch-over — ``ops/ivf.py`` documents why).

The search runs as a FEW jitted ``lax.scan`` dispatches over row-block
groups (per-dispatch FLOPs capped): each step dynamic-slices a
fixed-width column window out of the device-resident vector matrix (the
window start is a per-block host-computed offset), so the dispatch count
stays tiny at any n.

All similarities are inner products of L2-normalized vectors; distance =
1 - similarity.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.float32(-2.0)  # below any cosine similarity


def _pow2_at_least(x: int, minimum: int = 512) -> int:
    size = minimum
    while size < x:
        size *= 2
    return size


def band_bounds(mzs: np.ndarray, tol_mass: float, tol_is_da: bool):
    """Per-row tolerance-band bounds (inclusive lo, exclusive hi) of
    SORTED precursor m/z, covering the device kernels' acceptance.

    The kernels compare FLOAT32-cast m/z, so the bounds are computed
    from the same f32 values, widened by a few f32 ULPs — a window
    derived from the f64 m/z can exclude a boundary pair the f32 kernel
    accepts, making neighbor sets depend on block geometry.
    Over-coverage is harmless: membership is decided by the kernel's own
    in-tile tolerance mask; the window only gates candidate visibility.
    Shared by the banded scan (this module), the hash-free exact index
    (``ops/exact_knn.py``) and the multi-chip halo k-NN
    (``parallel/sharded_knn.py``) so all three stay coverage-identical.
    """
    mzs32 = np.asarray(mzs, np.float64).astype(np.float32).astype(
        np.float64)
    ulp = 4e-7  # ~3.4 float32 ULPs of relative slack
    if tol_is_da:
        slack = ulp * np.abs(mzs32)
        lo_vals = mzs32 - tol_mass - slack
        hi_vals = mzs32 + tol_mass + slack
    else:
        # The kernel accepts |q-c|/c*1e6 <= tol, i.e. candidates up to
        # q/(1-tol/1e6) (> q*(1+tol/1e6) by ~q*tol^2).
        lo_vals = mzs32 / (1 + tol_mass / 1e6) * (1 - ulp)
        hi_vals = mzs32 / (1 - tol_mass / 1e6) * (1 + ulp)
    return (np.searchsorted(mzs32, lo_vals, side="left"),
            np.searchsorted(mzs32, hi_vals, side="right"))


@functools.partial(
    jax.jit,
    static_argnames=("k", "tol_is_da", "block_rows", "window",
                     "exact_topk", "exclude_diag", "scan_bf16",
                     "with_counts"),
)
def _banded_topk(
    vectors: jnp.ndarray,     # (n_pad, D) L2-normalized, row-padded with 0
    mzs: jnp.ndarray,         # (n_pad,) precursor m/z, padded with +inf
    col_starts: jnp.ndarray,  # (n_blocks,) column window start per block
    tol_mass: jnp.ndarray,    # scalar
    k: int,
    tol_is_da: bool,
    block_rows: int,
    window: int,
    exact_topk: bool = False,
    q_vectors: Optional[jnp.ndarray] = None,  # asymmetric query matrix
    q_mzs: Optional[jnp.ndarray] = None,      # query m/z when distinct
    exclude_diag: bool = True,
    row_offset=0,  # traced: first query row this dispatch covers
    scan_bf16: bool = False,
    prev_scores: Optional[jnp.ndarray] = None,  # (n_pad,) continuation
    prev_ids: Optional[jnp.ndarray] = None,     # (n_pad,) boundary ids
    with_counts: bool = False,
    count_thr=0.0,  # traced scalar: threshold for the exact counts
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Banded top-k for ``len(col_starts)`` row blocks starting at
    ``row_offset``: one scan over row blocks on device.

    ``row_offset`` + the per-dispatch block count let the caller split
    very large scans into several bounded dispatches, and bands wider
    than one window are covered with multiple column PASSES whose
    results merge in a separate tiny dispatch (``knn_banded``).  An
    in-scan running-top-k merge over column chunks faulted on the
    device this code was first built for (n_chunks * k >= 1024); that
    limit is not measured on the H100, and the per-pass scans stay.

    ``exclude_diag`` drops pairs whose query and column POSITIONS match
    (self-pairs when queries are the columns); disable it when query
    row i is unrelated to column row i (external queries, ops/ivf.py).

    ``scan_bf16`` runs the matmul with bfloat16 INPUTS and float32
    accumulation (tensor-core native: half the memory traffic of the
    streamed window).  CERTIFIED ERROR BOUND for callers that
    threshold the result (the upper-bound prefilter): each bf16 cast is
    x(1 + e) with |e| <= 2^-8, so a product of two casts is >=
    x*y*(1 - 2^-7), and f32 accumulation of D nonnegative products adds
    <= D * 2^-23 relative error (~6e-5 at D = 512); hence
    sims_bf16 >= sims_f32 * (1 - 2^-7 - 1e-4) > sims_f32 * (1 - 0.009).
    A caller keeping candidates with sims_bf16 >= thr * (1 - 0.01)
    therefore never drops a candidate whose true bound reaches ``thr``
    (cluster/ann_engine.py applies exactly this margin).  Only sound
    when a downstream exact stage re-scores survivors — eps-threshold
    consumers must keep f32.  Without ``scan_bf16`` the product runs at
    ``Precision.HIGHEST``: a GPU would otherwise be free to run an f32
    product in TF32 (10 mantissa bits), and the ``--rerank off`` eps
    scan compares these similarities with the threshold directly.

    ``prev_scores``/``prev_ids`` (both or neither): per-QUERY-row
    continuation boundary for multi-pass retrieval beyond one top-k
    width (round-4 verdict item 8).  The retrieval order is the strict
    total order (score DESC, column id ASC) — ``lax.top_k`` breaks
    score ties by lower position, positions are column ids within a
    window, and the column passes merge left to right — so a pass that
    keeps only candidates strictly AFTER boundary ``(b, b_id)`` in that
    order (``sims < b`` or ``sims == b and id > b_id``) returns the
    next k candidates exactly: no duplicates, no drops, deterministic
    progress even on all-tied bands (duplicate spectra).  Soundness
    needs bitwise-identical ``sims`` across passes, so pass 1 runs the
    SAME program with the sentinel boundary ``(+inf, -1)``.

    ``with_counts``: additionally return the EXACT per-query-row count
    of masked-valid candidates with ``sims >= count_thr`` in this
    window — one elementwise compare + row sum fused into the step
    (bandwidth-trivial next to the matmul).  This is the certificate
    the approx retrieval path rides on (``knn_banded`` certified mode,
    see there): the prefilter scan may retrieve with ``approx_max_k``
    and PROVE completeness against these counts instead of paying for
    exact order it doesn't need.
    """
    if q_vectors is None:
        q_vectors = vectors
    if q_mzs is None:
        q_mzs = mzs
    if scan_bf16:
        vectors = vectors.astype(jnp.bfloat16)
        q_vectors = q_vectors.astype(jnp.bfloat16)
    n_blocks = col_starts.shape[0]
    k_c = min(k, window)

    def step(row_offset, b):
        r0 = row_offset + b * block_rows
        c0 = col_starts[b]
        q = jax.lax.dynamic_slice_in_dim(q_vectors, r0, block_rows)
        q_mz = jax.lax.dynamic_slice_in_dim(q_mzs, r0, block_rows)
        q_rows = r0 + jnp.arange(block_rows, dtype=jnp.int32)
        c = jax.lax.dynamic_slice_in_dim(vectors, c0, window)
        c_mz = jax.lax.dynamic_slice_in_dim(mzs, c0, window)
        sims = jnp.dot(
            q, c.T, preferred_element_type=jnp.float32,
            precision=None if scan_bf16 else jax.lax.Precision.HIGHEST)
        diff = q_mz[:, None] - c_mz[None, :]
        if tol_is_da:
            mass_diff = jnp.abs(diff)
        else:
            mass_diff = jnp.abs(diff / c_mz[None, :] * 1e6)
        c_rows = c0 + jnp.arange(window, dtype=jnp.int32)
        valid = (
            (mass_diff <= tol_mass)
            & jnp.isfinite(c_mz)[None, :]  # candidate padding
        )
        if exclude_diag:
            valid &= q_rows[:, None] != c_rows[None, :]
        sims = jnp.where(valid, sims, NEG)
        if prev_scores is not None:
            b_s = jax.lax.dynamic_slice_in_dim(
                prev_scores, r0, block_rows)[:, None]
            b_i = jax.lax.dynamic_slice_in_dim(
                prev_ids, r0, block_rows)[:, None]
            after = (sims < b_s) | ((sims == b_s)
                                    & (c_rows[None, :] > b_i))
            sims = jnp.where(after, sims, NEG)
        if exact_topk:
            # No downstream rerank to absorb misses: exact top-k so the
            # band search really is "exact within the band".
            top_scores, top_pos = jax.lax.top_k(sims, k_c)
        else:
            # Approximate retrieval (recall_target=0.99); the exact
            # rerank downstream re-ranks candidates anyway, and the
            # certified mode proves completeness by count.  Its cost
            # against lax.top_k on a GPU is measured by chip_smoke.py.
            top_scores, top_pos = jax.lax.approx_max_k(
                sims, k_c, recall_target=0.99
            )
        top_idx = jnp.where(
            top_scores > NEG, c0 + top_pos.astype(jnp.int32), -1
        )
        if with_counts:
            cnt = jnp.sum(sims >= count_thr, axis=1).astype(jnp.int32)
            return row_offset, (top_scores, top_idx, cnt)
        return row_offset, (top_scores, top_idx)

    _, out = jax.lax.scan(
        step, jnp.asarray(row_offset, jnp.int32),
        jnp.arange(n_blocks, dtype=jnp.int32),
    )
    nq = n_blocks * block_rows
    if with_counts:
        scores, idx, counts = out
        return (scores.reshape(nq, k_c), idx.reshape(nq, k_c),
                counts.reshape(nq))
    scores, idx = out
    return (
        scores.reshape(nq, k_c),
        idx.reshape(nq, k_c),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_topk(s1, i1, s2, i2, k: int):
    """Merge two (rows, k') top-k result pairs into the best k."""
    cat_s = jnp.concatenate([s1, s2], axis=1)
    cat_i = jnp.concatenate([i1, i2], axis=1)
    ms, mp = jax.lax.top_k(cat_s, k)
    return ms, jnp.take_along_axis(cat_i, mp, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def _merge_topk_payload(s1, i1, m1, s2, i2, m2, k: int):
    """``_merge_topk`` carrying a per-candidate int payload (match
    counts): rank by score, gather ids and payload with the same
    permutation.  Used by the multi-pass neighbor widening so
    min_matches zeroing can run AFTER the cross-pass selection —
    identical semantics to a single wide pass (rerank selects by TRUE
    exact score, zeroing only rewrites the kept values)."""
    cat_s = jnp.concatenate([s1, s2], axis=1)
    cat_i = jnp.concatenate([i1, i2], axis=1)
    cat_m = jnp.concatenate([m1, m2], axis=1)
    ms, mp = jax.lax.top_k(cat_s, k)
    return (ms, jnp.take_along_axis(cat_i, mp, axis=1),
            jnp.take_along_axis(cat_m, mp, axis=1))


@jax.jit
def _mask_invalid(scores, idx, n, rts, rt_tol):
    """Device-side invalid-neighbor masking (+ optional RT filter).

    ``n`` is traced so one executable serves every dataset size of the
    same padded shape."""
    bad = (idx < 0) | (idx >= n)
    if rts is not None:
        row_rt = rts[: scores.shape[0]]
        neigh_rt = rts[jnp.clip(idx, 0, rts.shape[0] - 1)]
        bad = bad | (jnp.abs(neigh_rt - row_rt[:, None]) > rt_tol)
    return (jnp.where(bad, NEG, scores),
            jnp.where(bad, -1, idx))


def knn_banded(
    vectors: np.ndarray,
    precursor_mzs: np.ndarray,
    tol_mass: float,
    tol_mode: str,
    k: int,
    block_rows: int = 1024,
    rts: Optional[np.ndarray] = None,
    rt_tol: Optional[float] = None,
    as_device: bool = False,
    exact_topk: bool = False,
    q_vectors=None,
    scan_bf16: bool = False,
    want_boundary: bool = False,
    resume_boundary=None,
    certified_thr: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors within the precursor tolerance band.

    ``exact_topk=True`` uses exact ``lax.top_k`` per block instead of
    ``approx_max_k`` (recall_target 0.99); set it whenever
    no exact rerank stage runs downstream to absorb approximate misses.

    ``q_vectors``: optional distinct query matrix (same shape contract as
    ``vectors``) for asymmetric scoring — used by the engine's
    tolerance-spread upper-bound prefilter, which scores
    ``spread_query . plain_column``.

    ``vectors`` (n, D) L2-normalized (NumPy or device array),
    ``precursor_mzs`` (n,) SORTED ascending.  Returns (similarities
    (n, k), neighbor row indices (n, k)); missing neighbors have
    similarity -2 and index -1.

    With ``as_device=True`` the results stay on device as PADDED
    ``(n_pad, >= k)`` arrays (rows past n are garbage; padded columns are
    already masked) — fetch nothing, chain into the rerank / density
    stages.  The RT filter is applied on device in that case.

    The column window is the power-of-two envelope of the widest band
    plus a row block, capped at n_pad, and is STREAMED through HBM in
    fixed-size chunks with a running top-k merge — any band width runs
    in bounded memory (no index switch-over).

    Multi-pass retrieval beyond one top-k width (``want_boundary`` /
    ``resume_boundary``; requires ``as_device`` and ``exact_topk``):
    with ``want_boundary=True`` the return gains a third element, the
    per-row continuation boundary ``(scores (n_pad,), ids (n_pad,))``
    of this pass's LAST retrieved candidate in the strict (score DESC,
    id ASC) retrieval order, taken BEFORE the RT/validity mask (a
    masked last column must not truncate the continuation).  Feeding it
    back as ``resume_boundary`` returns the NEXT k candidates of every
    row — exactly, with no duplicates (see ``_banded_topk``).  Rows
    whose band is exhausted return boundary score -2 and only -1 ids on
    later passes.  Callers bound total HBM by keeping each pass at the
    proven-safe (rows, k) shape class instead of widening k past the
    measured worker-fault envelope (round-4 verdict item 8).
    Precondition: real candidate scores must stay above the NEG
    sentinel (-2) — true for cosines of normalized vectors and for the
    nonnegative-embedding upper-bound scan; a score at or below NEG is
    indistinguishable from a masked candidate and would be dropped.

    ``certified_thr`` (requires ``as_device=True``, incompatible with
    ``exact_topk``/boundary): CERTIFIED threshold retrieval.  The scan
    retrieves with ``approx_max_k`` at wide sub-windows (where exact
    ``lax.top_k`` dominates the dispatch — see the geometry gate in
    the body) and with exact top-k at narrow ones, and ALWAYS
    computes, fused into each step, the EXACT per-row count of
    band-valid candidates with score >= ``certified_thr``; the return
    gains a third element ``ok`` (host bool) that is True iff every
    real row's retrieved >=thr candidates equal its exact count.
    ``ok=True`` PROVES the lists contain every band-valid candidate
    with score >= the threshold (the only candidates a downstream
    threshold compaction keeps — their order is irrelevant because the
    exact rerank re-scores survivors); a count exceeding ``k`` or an
    approx miss above the threshold both surface as ``ok=False``, and
    the caller falls back to the exact-top-k path.  Motivation: where
    the exact sort dominates the scan, approximate retrieval plus the
    certificate is cheaper (the gate in the body was tuned on the
    device this code was first built for; see ROADMAP).
    """
    n = len(precursor_mzs)
    mzs = np.asarray(precursor_mzs, np.float64)
    tol_is_da = tol_mode == "Da"

    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)

    n_pad = _pow2_at_least(n)
    block_rows = min(block_rows, n_pad)

    # Per row block, the column window must span the union of its rows'
    # bands (exact, from the per-row band bounds).  Window width = the
    # power-of-two envelope of the widest such span.  The per-step
    # (block_rows, window) similarity tile is bounded to ~128 MB of
    # device memory by shrinking the row block for very wide bands (cap
    # inherited from a 16 GB device; not measured on the H100).
    def block_windows(br: int) -> Tuple[np.ndarray, int]:
        starts = np.zeros(n_pad // br, np.int32)
        max_span = br
        for b in range(len(starts)):
            r0 = b * br
            if r0 >= n:
                continue
            r1 = min(r0 + br, n)
            lo = int(band_lo[r0])
            hi = max(int(band_hi[r1 - 1]), r1)
            max_span = max(max_span, hi - lo)
            starts[b] = lo
        return starts, max_span

    while True:
        starts, max_span = block_windows(block_rows)
        window = min(_pow2_at_least(max_span, block_rows), n_pad)
        if block_rows <= 512 or block_rows * window * 4 <= 128 * 2**20:
            break
        block_rows //= 2
    # Column passes: a band wider than one sub-window is covered by
    # several scans over adjacent column sub-windows, merged by a
    # separate top-k dispatch (_merge_topk) — per-program memory is
    # O(block_rows x sub_window) at ANY band width (see _banded_topk
    # for why the merge is a separate dispatch).  The 128 MB tile cap
    # and the 2^27-byte sub-window cap are inherited from a 16 GB
    # device; not measured on the H100.
    import os as _os

    d_vec = vectors.shape[1]
    k_eff = min(k, window)
    sub_window = window
    sub_floor = max(block_rows, _pow2_at_least(k_eff, 512))
    sub_cap = max(sub_floor, 2**27 // (4 * max(d_vec, 1)))
    while ((sub_window > sub_cap
            or block_rows * sub_window * 4 > 128 * 2**20)
           and sub_window // 2 >= sub_floor):
        sub_window //= 2
    env_cc = _os.environ.get("FALCON_TPU_KNN_COL_CHUNK")
    if env_cc:  # test hook: force multi-pass coverage at small scales
        # Floor at k: a sub-window narrower than k would make the
        # per-pass top-k width smaller than the merge's k (top_k
        # rejects k > width).
        sub_window = min(window,
                         _pow2_at_least(max(int(env_cc), k_eff), 128))
    n_passes = window // sub_window
    # Clamp starts so every block's FULL window stays in bounds (then
    # every pass start + sub_window <= n_pad as well).
    starts = np.minimum(starts, max(n_pad - window, 0))

    d = vectors.shape[1]

    def to_dev(v):
        if isinstance(v, np.ndarray):
            v_pad = np.zeros((n_pad, d), np.float32)
            v_pad[:n] = v[:n]
            return jnp.asarray(v_pad)
        if v.shape[0] < n_pad:
            return jnp.pad(v, ((0, n_pad - v.shape[0]), (0, 0)))
        return v[:n_pad]

    v_dev = to_dev(vectors)
    mz_pad = np.full(n_pad, np.inf, np.float32)
    mz_pad[:n] = mzs
    mz_dev = jnp.asarray(mz_pad)
    q_dev = None if q_vectors is None else to_dev(q_vectors)
    boundary = want_boundary or resume_boundary is not None
    if boundary and not (as_device and exact_topk):
        raise ValueError(
            "boundary continuation requires as_device=True and "
            "exact_topk=True (tie order is only guaranteed by lax."
            "top_k; host outputs would re-pad past the boundary)")
    if certified_thr is not None and (exact_topk or boundary
                                      or not as_device):
        raise ValueError(
            "certified_thr is the approx-retrieval certificate: it "
            "requires as_device=True and excludes exact_topk/boundary "
            "(those paths already guarantee exact order)")
    # Geometry gate for the certified mode's RETRIEVAL mechanism: at
    # wide sub-windows approx_max_k + the count certificate is used, at
    # narrow ones exact top-k.  The gate was tuned on the device this
    # code was first built for and is not re-derived for the H100
    # (ROADMAP §3); chip_smoke.py reports both retrievals' times.
    # Certified mode keeps exact top-k retrieval at narrow windows
    # (the certificate test is unchanged: exact top-k trivially
    # contains every above-thr candidate whenever the count fits k,
    # and a count > k still surfaces as ok=False for the caller's
    # widening/fallback logic).
    cert_exact = certified_thr is not None and not (
        sub_window >= 16384 and sub_window >= 64 * k_eff)
    if resume_boundary is not None:
        prev_s, prev_i = resume_boundary
        prev_s = jnp.asarray(prev_s, jnp.float32)
        prev_i = jnp.asarray(prev_i, jnp.int32)
    elif boundary:
        # Pass 1 of a multi-pass retrieval runs the SAME program with
        # the sentinel boundary so sims stay bitwise identical across
        # passes (the continuation mask compares floats for equality).
        prev_s = jnp.full(n_pad, jnp.inf, jnp.float32)
        prev_i = jnp.full(n_pad, -1, jnp.int32)
    else:
        prev_s = prev_i = None
    # Bound one dispatch's matmul work: grouping row blocks into
    # equal-sized dispatches keeps one compiled executable.  The 5 PFLOP
    # cap is inherited from a 16 GB device; not measured on the H100.
    flops_per_block = 2.0 * block_rows * sub_window * d
    cap_pflops = float(_os.environ.get(
        "FALCON_TPU_KNN_DISPATCH_PFLOPS", "5"))
    per_dispatch = max(1, int(cap_pflops * 1e15 / max(flops_per_block,
                                                      1.0)))
    n_blocks_total = len(starts)
    per_dispatch = min(per_dispatch, n_blocks_total)
    pad_blocks = (-n_blocks_total) % per_dispatch
    starts_pad = np.concatenate([
        starts,
        np.full(pad_blocks, max(n_pad - window, 0), np.int32),
    ]).astype(np.int32)
    with_counts = certified_thr is not None
    parts_s, parts_i, parts_c = [], [], []
    for g0 in range(0, len(starts_pad), per_dispatch):
        group = starts_pad[g0:g0 + per_dispatch]
        acc_s = acc_i = acc_c = None
        for p in range(n_passes):
            out = _banded_topk(
                v_dev, mz_dev,
                jnp.asarray(group + np.int32(p * sub_window)),
                jnp.float32(tol_mass), int(k_eff), tol_is_da,
                int(block_rows), int(sub_window),
                exact_topk=bool(exact_topk) or cert_exact,
                q_vectors=q_dev,
                row_offset=g0 * block_rows,
                scan_bf16=bool(scan_bf16),
                prev_scores=prev_s, prev_ids=prev_i,
                with_counts=with_counts,
                count_thr=jnp.float32(certified_thr or 0.0),
            )
            if with_counts:
                s_g, i_g, c_g = out
                # Column sub-windows are disjoint: counts add.
                acc_c = c_g if acc_c is None else acc_c + c_g
            else:
                s_g, i_g = out
            if acc_s is None:
                acc_s, acc_i = s_g, i_g
            else:
                acc_s, acc_i = _merge_topk(acc_s, acc_i, s_g, i_g,
                                           int(k_eff))
        parts_s.append(acc_s)
        parts_i.append(acc_i)
        if with_counts:
            parts_c.append(acc_c)
    if len(parts_s) == 1:
        scores, idx = parts_s[0][:n_pad], parts_i[0][:n_pad]
        counts = parts_c[0][:n_pad] if with_counts else None
    else:
        scores = jnp.concatenate(parts_s)[:n_pad]
        idx = jnp.concatenate(parts_i)[:n_pad]
        counts = jnp.concatenate(parts_c)[:n_pad] if with_counts else None
    certified_ok = None
    if with_counts:
        # Certificate: every REAL row's retrieved >=thr candidates must
        # equal its exact in-band count (computed pre-RT-mask, like the
        # retrieval itself — the RT mask only removes candidates and is
        # applied identically downstream on both paths).  One scalar
        # is read back to the host.
        retrieved = jnp.sum(
            scores >= jnp.float32(certified_thr), axis=1
        ).astype(jnp.int32)
        row_real = jnp.arange(n_pad, dtype=jnp.int32) < n
        certified_ok = bool(jnp.all(
            jnp.where(row_real, retrieved == counts, True)
        ))
    # Continuation boundary = each row's LAST retrieved candidate,
    # extracted from the RAW merged top-k (before the RT/validity mask
    # below rewrites scores — a masked candidate still consumed its
    # position in the retrieval order).
    out_boundary = (scores[:, -1], idx[:, -1]) if want_boundary else None
    if as_device:
        # Mask out-of-range neighbor ids (padded rows of the column
        # windows) and optionally RT-filter, all on device.
        scores, idx = _mask_invalid(
            scores, idx, n,
            None if rts is None or rt_tol is None else
            jnp.asarray(np.concatenate(
                [np.asarray(rts, np.float32),
                 np.full(n_pad - n, np.inf, np.float32)]
            )),
            np.inf if rt_tol is None else float(rt_tol),
        )
        if want_boundary:
            return scores, idx, out_boundary
        if certified_thr is not None:
            return scores, idx, certified_ok
        return scores, idx
    out_scores = np.array(scores[:n])  # writable host copies
    out_idx = np.asarray(idx)[:n].astype(np.int64)
    if out_scores.shape[1] < k:  # window smaller than k: pad columns
        pad = k - out_scores.shape[1]
        out_scores = np.concatenate(
            [out_scores, np.full((n, pad), float(NEG), np.float32)], axis=1
        )
        out_idx = np.concatenate(
            [out_idx, np.full((n, pad), -1, np.int64)], axis=1
        )
    # Mask any padded-row artifacts (rows >= n never queried; indices of
    # padding columns already -1 via the isfinite mask).
    bad = out_idx >= n
    out_scores[bad] = float(NEG)
    out_idx[bad] = -1

    # Optional retention-time post-filter.
    if rt_tol is not None and rts is not None:
        rts = np.asarray(rts, np.float64)
        neigh_rt = np.where(out_idx >= 0, rts[np.clip(out_idx, 0, n - 1)],
                            np.inf)
        bad = np.abs(neigh_rt - rts[:, None]) > rt_tol
        out_scores[bad] = float(NEG)
        out_idx[bad] = -1
    return out_scores, out_idx
