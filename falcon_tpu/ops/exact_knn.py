"""Exact banded k-NN: peak-matching cosine over the precursor band.

The published falcon pipeline approximates neighbor search with hashed
vectors (reference ``README.md:132-142``); this op instead scores EVERY
in-band pair with the exact locally-dominant matching kernel and takes
the top-k — no hash anywhere in the loop, recall@k = 1.0 vs exact
cosine by construction.

Status: ALTERNATIVE / VERIFICATION backend, reachable via
``--ann_index exact`` (the ann engine then skips hashing, prefilter,
and rerank and feeds these exact scores straight to DBSCAN).  The
production default in ``cluster/ann_engine.py`` remains the
tolerance-spread upper-bound prefilter + gather rerank
(label-identical to exhaustive exact scoring, tests/test_ann.py) —
this module is the hash-free oracle path and a correctness cross-check
for it.

Banding: spectra are sorted by precursor m/z, so row i's candidates live
in a contiguous window starting at column tile ``starts[i]``; the panel
width is the power-of-two envelope of the widest band (tile-aligned),
NOT of a whole row block.  Each row's window is scored with the chunked
gather machinery of ``ops/rerank.py`` (plain XLA).
"""

import functools
from typing import Optional, Tuple

import numpy as np

from .knn import NEG, _pow2_at_least, band_bounds

COL_TILE = 128


def window_layout(
    mzs: np.ndarray, tol_mass: float, tol_mode: str, n_pad: int,
    tile: int = COL_TILE,
) -> Tuple[np.ndarray, int]:
    """Per-row column-window starts (in tiles) and the window width.

    ``mzs``: (n,) SORTED precursor m/z.  The window covers every row's
    full tolerance band; width = tile-aligned power-of-two envelope of
    the widest band.
    """
    # f32-consistent bounds shared with the banded scan (ops/knn.py):
    # the kernel compares f32 m/z, so the window must cover its f32
    # acceptance region.
    band_lo, band_hi = band_bounds(mzs, tol_mass, tol_mode == "Da")
    starts = (band_lo // tile).astype(np.int32)
    span = int((band_hi - starts * tile).max(initial=1))
    window = _pow2_at_least(span, tile)
    window = min(window, n_pad)
    n = len(mzs)
    starts = np.concatenate(
        [starts, np.zeros(n_pad - n, np.int32)]
    )
    starts = np.minimum(starts, (n_pad - window) // tile)
    return starts, window


def _topk_postlude():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("k", "tol_is_da",
                                                 "has_rt", "use_matches"))
    def fn(scores, matches, starts, mz_pad, rt_pad, tol_mass, rt_tol,
           n, min_matches, row_offset, k, tol_is_da, has_rt,
           use_matches):
        n_rows, w = scores.shape
        n_pad = mz_pad.shape[0]
        tile = COL_TILE
        row = row_offset + jnp.arange(n_rows, dtype=jnp.int32)
        col_ids = starts[:, None] * tile + jnp.arange(w, dtype=jnp.int32)
        col_safe = jnp.clip(col_ids, 0, n_pad - 1)
        c_mz = mz_pad[col_safe]
        diff = mz_pad[row][:, None] - c_mz
        if tol_is_da:
            mass_diff = jnp.abs(diff)
        else:
            mass_diff = jnp.abs(diff / c_mz * 1e6)
        valid = (
            (mass_diff <= tol_mass)
            & (row[:, None] != col_ids)
            & jnp.isfinite(c_mz)
            & (row[:, None] < n)
        )
        if has_rt:
            valid &= (jnp.abs(rt_pad[col_safe] - rt_pad[row][:, None])
                      <= rt_tol)
        if use_matches:
            scores = jnp.where(matches >= min_matches, scores, 0.0)
        sims = jnp.where(valid, scores, NEG)
        top_scores, top_pos = jax.lax.top_k(sims, k)
        top_idx = jnp.where(
            top_scores > NEG,
            jnp.take_along_axis(col_ids, top_pos, axis=1),
            -1,
        )
        return top_scores, top_idx

    return fn


_POSTLUDE = None


def exact_banded_topk(
    mz_pad_dev,              # (n_pad, P) padded peak m/z (device)
    int_pad_dev,             # (n_pad, P) L2-normalized intensities
    mzs: np.ndarray,         # (n,) SORTED precursor m/z (host)
    tol_mass: float,
    tol_mode: str,
    k: int,
    fragment_tol: float,
    rounds: int = 4,
    rts: Optional[np.ndarray] = None,
    rt_tol: Optional[float] = None,
    min_matches: int = 0,
) -> Tuple:
    """Exact top-k neighbors within the precursor band.

    Returns device-resident padded (n_pad, k) (similarities, neighbor
    ids) — the same contract as ``knn_banded(..., as_device=True)`` but
    with EXACT peak-matching cosine scores, so no rerank stage is
    needed downstream.
    """
    import os as _os

    import jax
    import jax.numpy as jnp

    from .knn import _merge_topk

    global _POSTLUDE
    n = len(mzs)
    n_pad, p = mz_pad_dev.shape
    starts, window = window_layout(mzs, tol_mass, tol_mode, n_pad)
    k = int(min(k, window))
    tol_is_da = tol_mode == "Da"
    with_matches = min_matches > 0

    # Column-pass streaming (SURVEY §5-g; round-4 verdict item 5): a
    # band wider than one sub-window is covered by PASSES over adjacent
    # column sub-windows, each an ordinary-shaped panel + top-k
    # dispatch, merged by a separate top-k dispatch (_merge_topk, the
    # same pass structure as ops/knn.py).  Rows stream in blocks so the
    # resident (block_rows, sub_window) score panel — NOT the widest
    # band — bounds device memory: the oracle path runs at ANY band
    # width, including a 500k one-band corpus whose (n_pad, n_pad)
    # panel could not fit.  The 128 MB panel cap is inherited from a
    # 16 GB device; not measured on the H100.
    sub_window = window
    block_rows = min(n_pad, int(_os.environ.get(
        "FALCON_TPU_EXACT_BLOCK_ROWS", "4096")))
    sub_floor = _pow2_at_least(k, COL_TILE)
    while (block_rows * sub_window * 4 > 128 * 2**20
           and sub_window // 2 >= sub_floor):
        sub_window //= 2
    env_cc = _os.environ.get("FALCON_TPU_EXACT_COL_CHUNK")
    if env_cc:  # test hook: force multi-pass coverage at small scales
        sub_window = min(window,
                         _pow2_at_least(max(int(env_cc), k), COL_TILE))
    n_passes = window // sub_window
    k_pass = int(min(k, sub_window))

    mz_host = np.full(n_pad, np.inf, np.float32)
    mz_host[:n] = mzs
    rt_host = np.full(n_pad, np.inf, np.float32)
    if rts is not None and rt_tol is not None:
        rt_host[:n] = rts
    mz_meta_dev = jnp.asarray(mz_host)
    rt_meta_dev = jnp.asarray(rt_host)
    if _POSTLUDE is None:
        _POSTLUDE = _topk_postlude()

    starts_dev = jnp.asarray(starts)
    tile_shift = sub_window // COL_TILE
    parts_s, parts_i = [], []
    for r0 in range(0, n_pad, block_rows):
        if r0 >= n and r0 > 0:
            # Padded row blocks: emit masked fillers without scoring.
            parts_s.append(jnp.full((block_rows, k_pass), float(NEG),
                                    jnp.float32))
            parts_i.append(jnp.full((block_rows, k_pass), -1,
                                    jnp.int32))
            continue
        mz_rows = jax.lax.dynamic_slice_in_dim(mz_pad_dev, r0,
                                               block_rows)
        int_rows = jax.lax.dynamic_slice_in_dim(int_pad_dev, r0,
                                                block_rows)
        st_block = jax.lax.dynamic_slice_in_dim(starts_dev, r0,
                                                block_rows)
        acc_s = acc_i = None
        for pss in range(n_passes):
            st_pass = st_block + jnp.int32(pss * tile_shift)
            scores, matches = _banded_panel(
                mz_rows, int_rows, mz_pad_dev, int_pad_dev,
                st_pass, sub_window, float(fragment_tol),
                int(rounds), with_matches,
            )
            s_g, i_g = _POSTLUDE(
                scores,
                matches if with_matches else scores,
                st_pass, mz_meta_dev, rt_meta_dev,
                jnp.float32(tol_mass),
                jnp.float32(np.inf if rt_tol is None else rt_tol),
                jnp.int32(n), jnp.int32(min_matches), jnp.int32(r0),
                k=k_pass, tol_is_da=tol_is_da,
                has_rt=rts is not None and rt_tol is not None,
                use_matches=with_matches,
            )
            if acc_s is None:
                acc_s, acc_i = s_g, i_g
            else:
                acc_s, acc_i = _merge_topk(acc_s, acc_i, s_g, i_g,
                                           k_pass)
        parts_s.append(acc_s)
        parts_i.append(acc_i)
    if len(parts_s) == 1:
        return parts_s[0], parts_i[0]
    return jnp.concatenate(parts_s), jnp.concatenate(parts_i)


def _banded_panel(mz_rows, int_rows, mz_pool, int_pool, starts,
                 window, fragment_tol, rounds, with_matches):
    """(n_rows, window) exact scores of each row against its column
    window (``starts`` in tiles), via the chunked gather machinery of
    ``ops/rerank.py``."""
    import jax
    import jax.numpy as jnp

    from .rerank import rerank_scan_body

    n_pool, p = mz_pool.shape

    @functools.partial(jax.jit, static_argnames=("window", "frag",
                                                 "rounds"))
    def fn(mz, intensity, pool_mz, pool_int, starts, window, frag,
           rounds):
        n_rows = mz.shape[0]
        cand = (starts[:, None] * COL_TILE
                + jnp.arange(window, dtype=jnp.int32))
        cand = jnp.clip(cand, 0, n_pool - 1)
        # keep ALL window columns; the postlude applies the masks.
        scores, ids, matches = rerank_scan_body(
            mz, intensity, pool_mz, pool_int, cand, frag,
            window, rounds, min(512, n_rows), 16,
        )
        # rerank sorts by score; restore window order via the ids.
        order = jnp.argsort(ids, axis=1)
        return (jnp.take_along_axis(scores, order, axis=1),
                jnp.take_along_axis(matches, order, axis=1))

    scores, matches = fn(mz_rows, int_rows, mz_pool, int_pool, starts,
                         int(window), float(fragment_tol), int(rounds))
    return scores, (matches if with_matches else None)
