"""Peak-matching cosine similarity as vectorized XLA ops.

Device replacement for the reference's per-pair ``cosine_fast``
(``falcon/cluster/similarity.py:17-80``): the reference builds a banded
cost matrix of intensity products for peaks within the fragment m/z
tolerance and solves an optimal bipartite assignment (Hungarian, via
``scipy.optimize.linear_sum_assignment`` in numba objmode).  The Hungarian
solve is inherently sequential and maps badly onto a data-parallel
device, so we use
**iterative locally-dominant matching**: each round simultaneously selects
every pair (p, q) whose weight is both its row maximum and its column
maximum (a "locally dominant" pair — greedy-safe: the globally maximal
entry is always locally dominant, so this refines greedy matching), adds
the selected weights, and removes the matched rows/columns.  A fixed
number of rounds bounds the work; with real spectra (tolerance-sparse,
near-diagonal cost matrices) the result is almost always identical to the
Hungarian optimum (quantified in ``tests/test_matching.py``).

All shapes are static: spectra come as padded ``(n, P)`` m/z / intensity
arrays (padding: m/z = -1e6, intensity = 0, see ``store.padded_peaks``),
so padded entries can never be within tolerance of a real peak and never
contribute weight.

Ties are broken toward the lowest index via a first-occurrence cumulative
mask (no gathers — everything is elementwise max/min/compare), which
also guarantees at most one selection per row and per column so scores are
never double-counted.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

DEFAULT_ROUNDS = 8


def _first_true(mask: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Keep only the first True along ``axis``.

    Implemented as an iota min-reduction (not a cumulative scan) so it maps
    to a single reduction inside the Pallas kernel.
    """
    idx = jax.lax.broadcasted_iota(jnp.int32, mask.shape,
                                   axis % mask.ndim)
    big = jnp.int32(mask.shape[axis])
    first = jnp.min(jnp.where(mask, idx, big), axis=axis, keepdims=True)
    return mask & (idx == first)


def match_rounds_body(w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """One locally-dominant matching round.

    ``w``: (..., P, P) non-negative weights.  Returns (new_w, selected,
    cand): the surviving weights, the selected weights (same shape as
    ``w``, zero where unselected), and the boolean selection mask.  Only
    max/min/sum reductions are used, so the body is reused verbatim by
    the Pallas-Triton kernel (``ops/pairwise.py``), whose lowering has no
    boolean any-reduction.
    """
    row_max = jnp.max(w, axis=-1, keepdims=True)
    col_max = jnp.max(w, axis=-2, keepdims=True)
    # Candidate: equals both its row and column maximum and is positive.
    cand = (w == row_max) & (w == col_max) & (w > 0)
    # Tie-break: first occurrence along the row, then along the column,
    # so each row and each column selects at most one entry.
    cand = _first_true(cand, axis=-1)
    cand = _first_true(cand, axis=-2)
    selected = jnp.where(cand, w, 0.0)
    # Remove matched rows and columns (a selected weight is > 0).
    row_hit = jnp.max(selected, axis=-1, keepdims=True) > 0
    col_hit = jnp.max(selected, axis=-2, keepdims=True) > 0
    new_w = jnp.where(row_hit | col_hit, 0.0, w)
    return new_w, selected, cand


def pair_weights(
    mz_a: jnp.ndarray,
    int_a: jnp.ndarray,
    mz_b: jnp.ndarray,
    int_b: jnp.ndarray,
    fragment_tol: float,
) -> jnp.ndarray:
    """Banded cost matrix of intensity products (reference
    ``similarity.py:42-63``): w[p, q] = int_a[p] * int_b[q] when
    |mz_a[p] - mz_b[q]| <= fragment_tol else 0."""
    within = (
        jnp.abs(mz_a[..., :, None] - mz_b[..., None, :]) <= fragment_tol
    )
    return jnp.where(within, int_a[..., :, None] * int_b[..., None, :], 0.0)


def match_score(
    w: jnp.ndarray, rounds: int = DEFAULT_ROUNDS
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``rounds`` locally-dominant matching rounds on weights ``w``.

    Returns (score clipped to [0, 1], n_matches) reducing the trailing two
    axes; leading axes are batched.
    """
    def body(carry):
        w, score, matches, r = carry
        w, selected, cand = match_rounds_body(w)
        return (
            w,
            score + jnp.sum(selected, axis=(-2, -1)),
            matches + jnp.sum(cand, axis=(-2, -1)),
            r + 1,
        )

    def cond(carry):
        w, _, _, r = carry
        # Early exit once every weight has been consumed (real spectrum
        # pairs typically finish in 1-2 rounds).
        return jnp.logical_and(r < rounds, jnp.max(w) > 0)

    score0 = jnp.zeros(w.shape[:-2], w.dtype)
    matches0 = jnp.zeros(w.shape[:-2], jnp.int32)
    _, score, matches, _ = jax.lax.while_loop(
        cond, body, (w, score0, matches0, jnp.int32(0))
    )
    return jnp.clip(score, 0.0, 1.0), matches


@functools.partial(jax.jit, static_argnames=("fragment_tol", "rounds"))
def pair_scores(
    mz_a: jnp.ndarray,
    int_a: jnp.ndarray,
    mz_b: jnp.ndarray,
    int_b: jnp.ndarray,
    fragment_tol: float,
    rounds: int = DEFAULT_ROUNDS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Similarity scores for a batch of spectrum pairs.

    All inputs are (..., P) padded arrays; returns (score, n_matches) with
    the leading batch shape.
    """
    w = pair_weights(mz_a, int_a, mz_b, int_b, fragment_tol)
    return match_score(w, rounds)
