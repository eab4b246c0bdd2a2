"""Blocked all-pairs spectrum similarity: the exact backend's pair panels.

This is the hot kernel of the exact backend: the reference evaluates
``cosine_fast`` once per spectrum pair with one ThreadPoolExecutor future
per pair (``falcon/cluster/cluster.py:630-637``, its hottest loop; SURVEY.md
§3.2); here one device call scores a whole (rows x cols) panel of pairs
with locally-dominant matching (``ops/matching.py`` has the algorithm
and its accuracy against the Hungarian optimum).

Two implementations of one contract, :func:`panel_scores`:

- ``panel_scores_triton``, a Pallas kernel on the Triton route, used on
  a GPU.  One program scores a (block_rows x block_cols) tile of pairs;
  each pair's (P, P) weight matrix lives in registers through its
  matching rounds and the pair exits as soon as its weights are
  consumed.  Programs entirely below the diagonal return at once when
  ``upper_only`` is set.
- ``panel_scores_xla``, the plain XLA code: pairs in fixed-size chunks
  under a ``lax.scan``, each chunk's (chunk, P, P) weights in device
  memory.  It runs everywhere else and is the reference the kernel is
  compared with.

Panels carry a leading batch axis, so the same call scores one large
interval's row panel (batch 1) or a group of small intervals at once.
Row, column and batch sizes are bucketed to powers of two so the number
of compiled shapes stays logarithmic in the largest interval.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .knn import _pow2_at_least
from .matching import (DEFAULT_ROUNDS, match_rounds_body, match_score,
                       pair_weights)

PAD_MZ = -1e6  # padding m/z: outside every tolerance window
# Kernel program shape.  On an H100 the block shape barely moves the
# kernel's time (PERF.md, kernel decisions): it is bound by the serial
# matching rounds of each pair, so these are not options.
BLOCK_ROWS = 4    # row spectra per program
BLOCK_COLS = 64   # column spectra per program
NUM_WARPS = 4


def panel_impl() -> str:
    """The pair-panel implementation for the platform this process runs
    on: the compiled Triton kernel on a GPU, plain XLA elsewhere."""
    return "pallas" if jax.default_backend() == "gpu" else "xla"


def _match_pair(w: jnp.ndarray, rounds: int):
    """Matching rounds on one (P, P) weight matrix inside the kernel;
    returns (score, matched peak count) as scalars."""
    def cond(carry):
        w, _, _, r = carry
        return jnp.logical_and(r < rounds, jnp.max(w) > 0)

    def body(carry):
        w, score, matches, r = carry
        w, selected, cand = match_rounds_body(w)
        return (w, score + jnp.sum(selected),
                matches + jnp.sum(cand.astype(jnp.int32)), r + 1)

    _, score, matches, _ = jax.lax.while_loop(
        cond, body, (w, jnp.float32(0.0), jnp.int32(0), jnp.int32(0)))
    return score, matches


def _pair_panel_kernel(mzr_ref, intr_ref, mzc_ref, intc_ref, score_ref,
                       *match_ref, fragment_tol: float, rounds: int,
                       upper_only: bool):
    block_rows, p = mzr_ref.shape
    block_cols = mzc_ref.shape[0]
    r0 = pl.program_id(1) * block_rows
    c0 = pl.program_id(2) * block_cols
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, block_cols), 1)

    def row_body(li, carry):
        mz_i = mzr_ref[pl.ds(li, 1), :].reshape(p, 1)
        int_i = intr_ref[pl.ds(li, 1), :].reshape(p, 1)

        def col_body(lj, acc):
            acc_s, acc_m = acc
            mz_j = mzc_ref[pl.ds(lj, 1), :]
            int_j = intc_ref[pl.ds(lj, 1), :]
            w = jnp.where(jnp.abs(mz_i - mz_j) <= fragment_tol,
                          int_i * int_j, 0.0)
            score, matches = _match_pair(w, rounds)
            hit = cols == lj
            return jnp.where(hit, score, acc_s), jnp.where(hit, matches, acc_m)

        # With upper_only, column j of row i is scored only when j > i;
        # the skipped part of the tile is written as zero.
        start = (jnp.clip(r0 + li + 1 - c0, 0, block_cols) if upper_only
                 else 0)
        acc_s, acc_m = jax.lax.fori_loop(
            start, block_cols, col_body,
            (jnp.zeros((1, block_cols), jnp.float32),
             jnp.zeros((1, block_cols), jnp.int32)))
        score_ref[pl.ds(li, 1), :] = jnp.clip(acc_s, 0.0, 1.0)
        if match_ref:
            match_ref[0][pl.ds(li, 1), :] = acc_m
        return carry

    jax.lax.fori_loop(0, block_rows, row_body, 0)


@functools.partial(
    jax.jit,
    static_argnames=("fragment_tol", "rounds", "upper_only", "with_matches",
                     "interpret"),
)
def panel_scores_triton(
    mz_rows: jnp.ndarray,
    int_rows: jnp.ndarray,
    mz_cols: jnp.ndarray,
    int_cols: jnp.ndarray,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    upper_only: bool = False,
    with_matches: bool = True,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Pallas-Triton pair panel.  Rows (B, R, P), columns (B, C, P), with
    R, C and P powers of two (:func:`panel_scores` pads them)."""
    b, n_rows, p = mz_rows.shape
    n_cols = mz_cols.shape[1]
    br, bc = min(BLOCK_ROWS, n_rows), min(BLOCK_COLS, n_cols)
    kernel = functools.partial(
        _pair_panel_kernel, fragment_tol=float(fragment_tol),
        rounds=int(rounds), upper_only=bool(upper_only))
    row_spec = pl.BlockSpec((None, br, p), lambda g, i, j: (g, i, 0))
    col_spec = pl.BlockSpec((None, bc, p), lambda g, i, j: (g, j, 0))
    out_spec = pl.BlockSpec((None, br, bc), lambda g, i, j: (g, i, j))
    out_shape = [jax.ShapeDtypeStruct((b, n_rows, n_cols), jnp.float32)]
    if with_matches:
        out_shape.append(
            jax.ShapeDtypeStruct((b, n_rows, n_cols), jnp.int32))
    outs = pl.pallas_call(
        kernel,
        grid=(b, n_rows // br, n_cols // bc),
        in_specs=[row_spec, row_spec, col_spec, col_spec],
        out_specs=[out_spec] * len(out_shape),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="pair_panel",
    )(mz_rows, int_rows, mz_cols, int_cols)
    return outs[0], (outs[1] if with_matches else None)


@functools.partial(
    jax.jit,
    static_argnames=("fragment_tol", "rounds", "upper_only", "with_matches",
                     "pair_chunk"),
)
def panel_scores_xla(
    mz_rows: jnp.ndarray,
    int_rows: jnp.ndarray,
    mz_cols: jnp.ndarray,
    int_cols: jnp.ndarray,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    upper_only: bool = False,
    with_matches: bool = True,
    pair_chunk: int = 4096,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Plain XLA pair panel, the reference for the kernel.  Same
    contract as :func:`panel_scores_triton`.

    Pairs are scored in chunks of ``pair_chunk`` under a ``lax.scan``.
    A square upper-only panel enumerates only its upper triangle; a
    rectangular one zeroes the weights of the pairs it skips (they are
    still gathered, but match no peak)."""
    b, n_rows, p = mz_rows.shape
    n_cols = mz_cols.shape[1]
    mz_r = mz_rows.reshape(b * n_rows, p)
    int_r = int_rows.reshape(b * n_rows, p)
    mz_c = mz_cols.reshape(b * n_cols, p)
    int_c = int_cols.reshape(b * n_cols, p)
    triangle = upper_only and n_rows == n_cols
    if triangle:
        iu_i, iu_j = jnp.triu_indices(n_rows, k=1)
        n_per = iu_i.shape[0]
    else:
        n_per = n_rows * n_cols
    n_pairs = b * n_per
    n_chunks = max(1, -(-n_pairs // pair_chunk))

    def pair_ids(c):
        pid = jnp.minimum(c * pair_chunk + jnp.arange(pair_chunk),
                          max(n_pairs - 1, 0))
        bb, t = jnp.divmod(pid, max(n_per, 1))
        if triangle:
            return bb, iu_i[t], iu_j[t]
        ii, jj = jnp.divmod(t, n_cols)
        return bb, ii, jj

    def chunk_fn(carry, c):
        bb, ii, jj = pair_ids(c)
        w = pair_weights(mz_r[bb * n_rows + ii], int_r[bb * n_rows + ii],
                         mz_c[bb * n_cols + jj], int_c[bb * n_cols + jj],
                         fragment_tol)
        if upper_only and not triangle:
            w = jnp.where((jj > ii)[:, None, None], w, 0.0)
        return carry, match_score(w, rounds)

    _, (scores, matches) = jax.lax.scan(
        chunk_fn, 0, jnp.arange(n_chunks))
    scores = scores.reshape(-1)[:n_pairs]
    matches = matches.reshape(-1)[:n_pairs]
    if triangle:
        bb = jnp.arange(n_pairs) // n_per
        t = jnp.arange(n_pairs) % n_per
        at = (bb, iu_i[t], iu_j[t])
        scores = jnp.zeros((b, n_rows, n_cols), jnp.float32).at[at].set(
            scores)
        matches = jnp.zeros((b, n_rows, n_cols), jnp.int32).at[at].set(
            matches)
    else:
        scores = scores.reshape(b, n_rows, n_cols)
        matches = matches.reshape(b, n_rows, n_cols)
    return scores, (matches if with_matches else None)


def panel_scores(
    mz_rows,
    int_rows,
    mz_cols,
    int_cols,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
    upper_only: bool = False,
    with_matches: bool = True,
    backend: Optional[str] = None,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Scores and matched-peak counts of every (row, column) spectrum
    pair of a batch of panels.

    Rows (B, R, P) and columns (B, C, P) padded peak arrays (padding
    m/z ``PAD_MZ``, intensity 0), R and C powers of two.  Returns
    (scores (B, R, C) float32, matches (B, R, C) int32 or None when
    ``with_matches`` is False).  With ``upper_only`` only pairs whose
    column index exceeds their row index are scored; the rest are 0.

    ``backend``: None picks by platform (:func:`panel_impl`); "pallas"
    is the compiled Triton kernel (GPU only), "pallas_interpret" the same
    kernel interpreted on the CPU (tests), "xla" the plain XLA code.
    """
    backend = backend or panel_impl()
    if backend == "xla":
        return panel_scores_xla(mz_rows, int_rows, mz_cols, int_cols,
                                float(fragment_tol), int(rounds),
                                bool(upper_only), bool(with_matches))
    if backend not in ("pallas", "pallas_interpret"):
        raise ValueError(f"unknown pair-panel backend {backend!r}")
    p = mz_rows.shape[-1]
    p2 = _pow2_at_least(p, 1)
    if p2 != p:  # Triton tensors have power-of-two dimensions.
        pad = ((0, 0), (0, 0), (0, p2 - p))
        mz_rows = jnp.pad(mz_rows, pad, constant_values=PAD_MZ)
        mz_cols = jnp.pad(mz_cols, pad, constant_values=PAD_MZ)
        int_rows = jnp.pad(int_rows, pad)
        int_cols = jnp.pad(int_cols, pad)
    return panel_scores_triton(
        mz_rows, int_rows, mz_cols, int_cols, float(fragment_tol),
        int(rounds), bool(upper_only), bool(with_matches),
        interpret=backend == "pallas_interpret")


def grouped_condensed_distances(
    interval_peaks,  # list of (mz (m_i, P), intensity (m_i, P))
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = DEFAULT_ROUNDS,
    max_group_cells: int = 16 * 2**20,
    devices=None,
    backend: Optional[str] = None,
):
    """Condensed distance matrices for many small intervals, batched.

    Intervals are bucketed by the power-of-two envelope of their size and
    scored in groups of up to ``max_group_cells`` (B * m_pad^2) cells per
    dispatch.  Yields (original interval index, condensed float32 pdist)
    in arbitrary order.  ``backend`` as in :func:`panel_scores`.

    ``devices``: optional list of JAX devices.  Group dispatches are
    round-robined over them with a bounded in-flight window (async
    dispatch keeps every device busy; results are fetched in dispatch
    order), so the linkage engine's per-component scoring scales over a
    ``--devices N`` mesh (SURVEY §2.4 / §7 step 5) instead of idling
    N - 1 chips during its dominant stage.
    """
    by_size = {}
    for idx, (mz, intensity) in enumerate(interval_peaks):
        m = mz.shape[0]
        m_pad = 8
        while m_pad < m:
            m_pad *= 2
        by_size.setdefault(m_pad, []).append(idx)

    tasks = []
    for m_pad, indices in sorted(by_size.items()):
        group_cap = max(1, max_group_cells // (m_pad * m_pad))
        for g0 in range(0, len(indices), group_cap):
            tasks.append((m_pad, indices[g0:g0 + group_cap]))

    def dispatch(task_i):
        m_pad, group = tasks[task_i]
        # Pad the group count to a power of two for stable shapes.
        b_pad = 1
        while b_pad < len(group):
            b_pad *= 2
        p = interval_peaks[group[0]][0].shape[1]
        mz_g = np.full((b_pad, m_pad, p), PAD_MZ, np.float32)
        int_g = np.zeros((b_pad, m_pad, p), np.float32)
        for gi, idx in enumerate(group):
            mz_i, int_i = interval_peaks[idx]
            mz_g[gi, : mz_i.shape[0]] = mz_i
            int_g[gi, : int_i.shape[0]] = int_i
        if devices:
            dev = devices[task_i % len(devices)]
            mz_d = jax.device_put(mz_g, dev)
            int_d = jax.device_put(int_g, dev)
        else:
            mz_d, int_d = jnp.asarray(mz_g), jnp.asarray(int_g)
        scores, matches = panel_scores(
            mz_d, int_d, mz_d, int_d, fragment_tol, rounds,
            upper_only=True, with_matches=min_matches > 0, backend=backend,
        )
        return group, scores, matches

    def drain(pending):
        group, scores, matches = pending.pop(0)
        scores = np.asarray(scores)
        if matches is not None:
            scores = np.where(np.asarray(matches) >= min_matches, scores,
                              0.0)
        out = []
        for gi, idx in enumerate(group):
            m = interval_peaks[idx][0].shape[0]
            iu = np.triu_indices(m, k=1)
            out.append(
                (idx, (1.0 - scores[gi][:m, :m][iu]).astype(np.float32))
            )
        return out

    window = 2 * len(devices) if devices else 1
    pending = []
    for task_i in range(len(tasks)):
        pending.append(dispatch(task_i))
        if len(pending) >= window:
            yield from drain(pending)
    while pending:
        yield from drain(pending)


@functools.partial(jax.jit, static_argnames=("thr", "panel"))
def _ub_pass_counts(spread, plain, thr, panel):
    """Per-row count of upper-triangle pairs whose tolerance-spread
    upper bound ``spread_i . plain_j`` reaches ``thr``.  One dispatch:
    a ``lax.scan`` over row panels of the (m, m) bound matrix.  The
    product runs at ``Precision.HIGHEST``: the caller's threshold margin
    (1e-3) is smaller than what a TF32 product may lose."""
    m = spread.shape[0]
    plain_t = plain.T
    cols = jnp.arange(m, dtype=jnp.int32)[None, :]

    def body(_, i):
        r0 = i * panel
        s = jax.lax.dynamic_slice_in_dim(spread, r0, panel)
        ub = jnp.dot(s, plain_t, precision=jax.lax.Precision.HIGHEST)
        rows = (r0 + jnp.arange(panel, dtype=jnp.int32))[:, None]
        ok = (cols > rows) & (ub >= thr)
        return 0, jnp.sum(ok, axis=1).astype(jnp.int32)

    _, counts = jax.lax.scan(
        body, 0, jnp.arange(m // panel, dtype=jnp.int32)
    )
    return counts.reshape(m)


@functools.partial(jax.jit, static_argnames=("thr", "k", "panel"))
def _ub_pass_topk(spread, plain, thr, k, panel):
    """Column ids of the upper-triangle pairs passing the spread bound,
    per row, -1 padded.  ``k`` must cover the max per-row pass count
    (from ``_ub_pass_counts``).  Per-panel ``top_k`` with no cross-step
    running merge (see ops/knn.py)."""
    m = spread.shape[0]
    plain_t = plain.T
    cols = jnp.arange(m, dtype=jnp.int32)[None, :]

    def body(_, i):
        r0 = i * panel
        s = jax.lax.dynamic_slice_in_dim(spread, r0, panel)
        ub = jnp.dot(s, plain_t, precision=jax.lax.Precision.HIGHEST)
        rows = (r0 + jnp.arange(panel, dtype=jnp.int32))[:, None]
        ok = (cols > rows) & (ub >= thr)
        vals, pos = jax.lax.top_k(jnp.where(ok, ub, -1.0), k)
        return 0, jnp.where(vals >= thr, pos.astype(jnp.int32), -1)

    _, ids = jax.lax.scan(
        body, 0, jnp.arange(m // panel, dtype=jnp.int32)
    )
    return ids.reshape(m, k)


# Pool-variant rerank (queries and candidate pool are different arrays)
# for row-chunked exact scoring of the pruned pair lists.
def _rerank_pool():
    from .rerank import rerank_scan_body

    return functools.partial(
        jax.jit,
        static_argnames=("fragment_tol", "k_out", "rounds", "chunk_q",
                         "chunk_c"),
    )(rerank_scan_body)


_RERANK_POOL = None


def pruned_condensed_distances(
    mz: np.ndarray,
    intensity: np.ndarray,
    hasher,
    eps: float,
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = 4,
    panel_rows: int = 1024,
    device=None,
) -> np.ndarray:
    """Condensed distances with provably-unused pairs clamped to 1.0.

    The linkage cut at ``eps`` (reference default semantics,
    ``falcon/cluster/cluster.py:280-290``) never reads the exact value
    of a distance > ``eps`` — for COMPLETE linkage every merge at
    height <= eps involves only pairwise distances <= eps (cluster
    diameter equals merge height), and for SINGLE linkage the flat
    clusters at eps are the connected components of the <=eps graph;
    reducible linkages are monotone, so all >eps merges happen above
    the cut in both the true and the clamped matrix.  Exact
    peak-matching scores are therefore computed ONLY for pairs whose
    tolerance-spread upper bound (``ops/vectorize.py`` docstring: a
    strict upper bound on the matched-peak score when bin width >=
    fragment tolerance) can reach ``1 - eps``; every other pair's
    distance is clamped to 1.0.  NOT valid for average linkage (merge
    heights are means over >eps distances too) — callers must keep
    full scoring there.

    Medoids (min row-sum, reference ``cluster.py:512-553``) read only
    intra-flat-cluster entries; under complete linkage those all have
    true distance <= eps, hence exact scores, so medoids are invariant
    too.  Under single linkage a chained flat cluster can span >eps
    pairs whose clamped value shifts row sums — a documented
    tie-break-level divergence (PARITY.md).

    Flow (all device work, 4 dispatches + small fetches): hash the
    block's peaks into spread/plain vectors, count passing pairs per
    row (one scanned matmul pass), take the per-row top-k_max bound
    ids (second pass), exact-score the surviving (row, col) pair lists
    with the rerank kernel (``ops/rerank.py``), and fill the condensed
    matrix on host with 1 - score (1.0 elsewhere).
    """
    from .knn import NEG, _pow2_at_least

    n = mz.shape[0]
    if n < 2:
        return np.zeros(0, np.float32)
    thr = 1.0 - float(eps) - 1e-3
    if thr <= 0.0:
        # eps ~ 1: nothing can be pruned.
        return condensed_distances(mz, intensity, fragment_tol,
                                   min_matches, rounds=DEFAULT_ROUNDS,
                                   device=device)
    m_pad = _pow2_at_least(n, 512)
    put = ((lambda a: jax.device_put(a, device)) if device is not None
           else jnp.asarray)
    mz_d = put(_pad_rows(np.asarray(mz, np.float32), m_pad, PAD_MZ))
    int_d = put(_pad_rows(np.asarray(intensity, np.float32), m_pad, 0.0))
    # Padding rows hash to zero vectors (PAD_MZ is outside the binning
    # range), so their bounds are 0 < thr and they can never pass.
    spread = hasher.vectorize(mz_d, int_d, norm=False, spread=True)
    plain = hasher.vectorize(mz_d, int_d, norm=False)
    panel = min(panel_rows, m_pad)

    counts = np.asarray(_ub_pass_counts(spread, plain, thr, panel))
    kmax = int(counts.max(initial=0))
    if kmax == 0:
        return np.ones(n * (n - 1) // 2, np.float32)
    k = _pow2_at_least(kmax, 16)
    if k > m_pad // 4:
        # Dense component: most pairs pass the bound, the panel kernel
        # is cheaper than gather-based pair scoring.
        return condensed_distances(mz, intensity, fragment_tol,
                                   min_matches, rounds=DEFAULT_ROUNDS,
                                   device=device)
    neigh = _ub_pass_topk(spread, plain, thr, k, panel)

    # Exact-score the pair lists, row-chunked so the resident (rows, k)
    # slabs stay bounded (rows * k <= 2^23; inherited from a 16 GB
    # device, not measured on the H100).
    row_chunk = m_pad
    while row_chunk * k > 2**23 and row_chunk > 512:
        row_chunk //= 2
    global _RERANK_POOL
    if _RERANK_POOL is None:
        _RERANK_POOL = _rerank_pool()
    scores = np.full((m_pad, k), float(NEG), np.float32)
    ids = np.full((m_pad, k), -1, np.int32)
    matches = np.zeros((m_pad, k), np.int32)
    for r0 in range(0, m_pad, row_chunk):
        s, i_, mt = _RERANK_POOL(
            jax.lax.dynamic_slice_in_dim(mz_d, r0, row_chunk),
            jax.lax.dynamic_slice_in_dim(int_d, r0, row_chunk),
            mz_d, int_d,
            jax.lax.dynamic_slice_in_dim(neigh, r0, row_chunk),
            fragment_tol=float(fragment_tol), k_out=k,
            rounds=int(rounds), chunk_q=min(512, row_chunk), chunk_c=16,
        )
        scores[r0:r0 + row_chunk] = np.asarray(s)
        ids[r0:r0 + row_chunk] = np.asarray(i_)
        matches[r0:r0 + row_chunk] = np.asarray(mt)

    out = np.ones(n * (n - 1) // 2, np.float32)
    scores, ids, matches = scores[:n], ids[:n], matches[:n]
    valid = (ids >= 0) & (scores > float(NEG))
    if min_matches > 0:
        # Reference semantics: too few matched peaks forces similarity
        # to 0, i.e. distance 1.0 — identical to the clamp
        # (falcon/cluster/cluster.py:620-626).
        valid &= matches >= min_matches
    ii = np.broadcast_to(
        np.arange(n, dtype=np.int64)[:, None], ids.shape
    )[valid]
    jj = ids[valid].astype(np.int64)
    cond = ii * n - ii * (ii + 1) // 2 + (jj - ii - 1)
    out[cond] = 1.0 - np.clip(scores[valid], 0.0, 1.0)
    return out


def _pad_rows(a: np.ndarray, target: int, fill: float) -> np.ndarray:
    n = a.shape[0]
    if n == target:
        return a
    return np.concatenate(
        [a, np.full((target - n,) + a.shape[1:], fill, a.dtype)], axis=0
    )


def condensed_distances(
    mz: np.ndarray,
    intensity: np.ndarray,
    fragment_tol: float,
    min_matches: int = 0,
    rounds: int = DEFAULT_ROUNDS,
    panel_rows: int = 2048,
    backend: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """Condensed upper-triangle distance matrix for one block of spectra.

    Semantics of reference ``compute_condensed_distance_matrix``
    (``falcon/cluster/cluster.py:593-639``): distance = 1 - similarity,
    with similarity forced to 0 when fewer than ``min_matches`` peaks
    match.

    Row panels stream over the upper triangle: the panel of rows
    [r0, r0 + panel_rows) is scored against the columns [r0, r0 + C)
    only, C the power-of-two bucket of the n - r0 remaining spectra, so
    device memory is O(panel_rows * n) and no pair below the diagonal
    is scored twice.  ``backend`` as in :func:`panel_scores`.
    """
    n = mz.shape[0]
    if n < 2:
        return np.zeros(0, np.float32)
    panel = min(panel_rows, _pow2_at_least(n, 64))
    spans = [(r0, _pow2_at_least(n - r0, panel))
             for r0 in range(0, n - 1, panel)]
    length = max(r0 + c for r0, c in spans)
    put = ((lambda a: jax.device_put(a, device)) if device is not None
           else jnp.asarray)
    mz_d = put(_pad_rows(np.asarray(mz, np.float32), length, PAD_MZ))
    int_d = put(_pad_rows(np.asarray(intensity, np.float32), length, 0.0))

    out = np.ones(n * (n - 1) // 2, np.float32)
    with_matches = min_matches > 0
    for r0, n_cols in spans:
        def block(a, size):
            return jax.lax.dynamic_slice_in_dim(a, r0, size)[None]

        scores, matches = panel_scores(
            block(mz_d, panel), block(int_d, panel),
            block(mz_d, n_cols), block(int_d, n_cols),
            fragment_tol, rounds, upper_only=True,
            with_matches=with_matches, backend=backend,
        )
        scores = np.asarray(scores[0])
        if with_matches:
            scores = np.where(np.asarray(matches[0]) >= min_matches,
                              scores, 0.0)
        for li in range(min(panel, n - 1 - r0)):
            gi = r0 + li
            # Condensed row slice for row gi: pairs (gi, gi+1..n-1).
            start = n * gi - gi * (gi + 1) // 2
            out[start:start + (n - 1 - gi)] = 1.0 - scores[li, li + 1:n - r0]
    return out
