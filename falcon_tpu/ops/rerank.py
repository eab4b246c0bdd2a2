"""Exact reranking of hashed nearest-neighbor candidates.

The published falcon algorithm builds its sparse distance matrix from
*hashed-vector* inner products (reference ``README.md:132-142``), which
bounds NN recall by the fidelity of the 400-dim feature hash.  falcon-tpu
adds a device refinement the reference never had: the hashed k-NN
stage over-retrieves ``n_neighbors_ann`` candidates, and this module
re-scores every (query, candidate) pair with the *exact* peak-matching
cosine (``ops/matching.py``, the same kernel the exact backend uses),
keeping the exact top ``n_neighbors``.  Density clustering then runs on
exact distances — recall@k vs exact cosine becomes the recall of the
candidate set (>= 0.99 at the defaults) instead of the recall of the
hash ranking, and ``eps`` has the same meaning in both backends.

The whole rerank is ONE jitted dispatch: a ``lax.scan`` over query
chunks, gathering candidate peak arrays from the device-resident padded
peak matrix, with an inner scan over candidate sub-chunks to bound the
(chunk_q, chunk_c, P, P) weight tensor.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .knn import NEG, _pow2_at_least
from .matching import match_score, pair_weights


def rerank_scan_body(
    mz: jnp.ndarray,       # (n_q, P) padded QUERY peak m/z
    intensity: jnp.ndarray,
    pool_mz: jnp.ndarray,  # (n_pool, P) candidate-pool peak m/z
    pool_int: jnp.ndarray,
    neigh: jnp.ndarray,    # (n_q, K) candidate POOL row ids, -1 = missing
    fragment_tol: float,
    k_out: int,
    rounds: int,
    chunk_q: int,
    chunk_c: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Plain (unjitted) rerank body.  Queries and the candidate pool are
    separate arrays so the multi-chip pipeline can pass halo-extended
    pools (``parallel/sharded_pipeline.py``); single-device passes the
    same array twice."""
    n_q = mz.shape[0]
    k_in = neigh.shape[1]
    n_chunks = n_q // chunk_q
    c_chunks = (k_in + chunk_c - 1) // chunk_c
    k_pad = c_chunks * chunk_c
    neigh = jnp.pad(neigh, ((0, 0), (0, k_pad - k_in)),
                    constant_values=-1)

    def q_step(_, qi):
        q0 = qi * chunk_q
        q_mz = jax.lax.dynamic_slice_in_dim(mz, q0, chunk_q)
        q_int = jax.lax.dynamic_slice_in_dim(intensity, q0, chunk_q)
        cand = jax.lax.dynamic_slice_in_dim(neigh, q0, chunk_q)

        def c_step(_, ci):
            c0 = ci * chunk_c
            ids = jax.lax.dynamic_slice_in_dim(cand, c0, chunk_c, axis=1)
            safe = jnp.maximum(ids, 0)
            c_mz = pool_mz[safe]         # (chunk_q, chunk_c, P)
            c_int = pool_int[safe]
            w = pair_weights(
                q_mz[:, None, :], q_int[:, None, :], c_mz, c_int,
                fragment_tol,
            )
            score, n_match = match_score(w, rounds)
            score = jnp.where(ids >= 0, score, NEG)
            return 0, (score, n_match)

        _, (scores, matches) = jax.lax.scan(
            c_step, 0, jnp.arange(c_chunks, dtype=jnp.int32)
        )
        scores = jnp.moveaxis(scores, 0, 1).reshape(chunk_q, k_pad)
        matches = jnp.moveaxis(matches, 0, 1).reshape(chunk_q, k_pad)
        top_scores, top_pos = jax.lax.top_k(scores, k_out)
        top_ids = jnp.take_along_axis(cand, top_pos, axis=1)
        top_matches = jnp.take_along_axis(matches, top_pos, axis=1)
        top_ids = jnp.where(top_scores > NEG, top_ids, -1)
        return 0, (top_scores, top_ids, top_matches)

    _, (scores, ids, matches) = jax.lax.scan(
        q_step, 0, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return (scores.reshape(n_q, k_out), ids.reshape(n_q, k_out),
            matches.reshape(n_q, k_out))


@functools.partial(
    jax.jit,
    static_argnames=("fragment_tol", "k_out", "rounds", "chunk_q",
                     "chunk_c"),
)
def _rerank_scan(mz, intensity, neigh, fragment_tol, k_out, rounds,
                 chunk_q, chunk_c):
    return rerank_scan_body(mz, intensity, mz, intensity, neigh,
                            fragment_tol, k_out, rounds, chunk_q, chunk_c)


def rerank_exact(
    mz_pad: np.ndarray,
    int_pad: np.ndarray,
    neigh: np.ndarray,
    fragment_tol: float,
    k_out: int,
    # Real spectrum pairs converge in 1-3 locally-dominant rounds and the
    # per-chunk while_loop exits early; 4 is a safe upper bound (scores
    # measured identical to rounds=8 on the bench corpus).
    rounds: int = 4,
    # (512, 16): small candidate tiles give the per-tile while_loop fine
    # early-exit granularity, which wins on real (tolerance-sparse)
    # spectra — measured faster than single-tile layouts on the bench
    # corpus even though synthetic dense data prefers bigger tiles.
    chunk_q: int = 512,
    chunk_c: int = 16,
    as_device: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact-score the candidate lists and keep the top ``k_out``.

    ``mz_pad``/``int_pad``: (n, P) padded peak arrays (host or device),
    ``neigh``: (n or n_pad, K) hashed-search candidate ids (-1 =
    missing; host or device — pass the device output of
    ``knn_banded(..., as_device=True)`` to avoid any round trip).
    Returns (scores (n, k_out) float32, ids (n, k_out) int64,
    matches (n, k_out) int32) ranked by exact matching cosine; missing
    entries score -2 / id -1 / matches 0.  With ``as_device=True`` the
    padded (n_pad, k) device arrays are returned unfetched instead.
    """
    n, p = mz_pad.shape
    k_in = neigh.shape[1]
    n_pad = _pow2_at_least(n, chunk_q)
    if isinstance(mz_pad, np.ndarray):
        mz_d = np.full((n_pad, p), -1e6, np.float32)
        int_d = np.zeros((n_pad, p), np.float32)
        mz_d[:n], int_d[:n] = mz_pad, int_pad
        mz_d, int_d = jnp.asarray(mz_d), jnp.asarray(int_d)
    else:
        mz_d = jnp.pad(mz_pad, ((0, n_pad - n), (0, 0)),
                       constant_values=-1e6)
        int_d = jnp.pad(int_pad, ((0, n_pad - n), (0, 0)))
    if isinstance(neigh, np.ndarray):
        neigh_d = np.full((n_pad, k_in), -1, np.int32)
        neigh_d[: len(neigh)] = neigh
        neigh_d = jnp.asarray(neigh_d)
    elif neigh.shape[0] < n_pad:
        neigh_d = jnp.pad(neigh, ((0, n_pad - neigh.shape[0]), (0, 0)),
                          constant_values=-1)
    else:
        neigh_d = neigh[:n_pad]
    scores, ids, matches = _rerank_scan(
        mz_d, int_d, neigh_d, float(fragment_tol),
        int(min(k_out, k_in)), int(rounds),
        int(min(chunk_q, n_pad)), int(chunk_c),
    )
    if as_device:
        return scores, ids, matches
    out_scores = np.array(scores[:n])
    out_ids = np.asarray(ids)[:n].astype(np.int64)
    out_matches = np.asarray(matches)[:n]
    if out_scores.shape[1] < k_out:
        pad = k_out - out_scores.shape[1]
        out_scores = np.concatenate(
            [out_scores,
             np.full((n, pad), float(NEG), np.float32)], axis=1
        )
        out_ids = np.concatenate(
            [out_ids, np.full((n, pad), -1, np.int64)], axis=1
        )
        out_matches = np.concatenate(
            [out_matches, np.zeros((n, pad), np.int32)], axis=1
        )
    return out_scores, out_ids, out_matches
