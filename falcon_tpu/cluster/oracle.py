"""Exact host-side similarity oracle.

Reproduces the reference's ``cosine_fast`` (``falcon/cluster/similarity.py:
17-80``) bit-for-bit in semantics: intensity products of peaks within the
fragment m/z tolerance form a cost matrix, the optimal bipartite assignment
(Hungarian) selects the matching, the score is the clipped sum of positive
selected products, and the match count is the number of positive selected
pairs.  Used as the ground-truth for validating the device kernels (SURVEY.md
§4: the CPU exact-cosine path is the oracle for the accelerated path).
"""

from typing import Tuple

import numpy as np
import scipy.optimize


def cosine_exact(
    mz1: np.ndarray,
    intensity1: np.ndarray,
    mz2: np.ndarray,
    intensity2: np.ndarray,
    fragment_mz_tolerance: float,
) -> Tuple[float, int]:
    """Peak-matching cosine similarity with optimal (Hungarian) assignment.

    Returns (score in [0, 1], number of matched peaks).
    """
    mz1 = np.asarray(mz1, np.float32)
    mz2 = np.asarray(mz2, np.float32)
    cost = np.where(
        np.abs(mz1[:, None] - mz2[None, :]) <= fragment_mz_tolerance,
        np.asarray(intensity1, np.float32)[:, None]
        * np.asarray(intensity2, np.float32)[None, :],
        np.float32(0.0),
    ).astype(np.float32)
    row_ind, col_ind = scipy.optimize.linear_sum_assignment(
        cost, maximize=True
    )
    pair_scores = cost[row_ind, col_ind]
    positive = pair_scores > 0.0
    score = float(min(max(pair_scores[positive].sum(), 0.0), 1.0))
    return score, int(positive.sum())


def condensed_distances_exact(
    mz: np.ndarray,
    intensity: np.ndarray,
    n_peaks: np.ndarray,
    fragment_mz_tolerance: float,
    min_matches: int,
) -> np.ndarray:
    """Condensed all-pairs distance matrix on padded peak arrays.

    Matches reference ``compute_condensed_distance_matrix``
    (``falcon/cluster/cluster.py:593-639``): distance = 1 - similarity,
    similarity forced to 0 when fewer than ``min_matches`` peaks match.
    """
    n = len(n_peaks)
    out = np.zeros(n * (n - 1) // 2, np.float64)
    k = 0
    for i in range(n - 1):
        pi = int(n_peaks[i])
        for j in range(i + 1, n):
            pj = int(n_peaks[j])
            sim, n_match = cosine_exact(
                mz[i, :pi],
                intensity[i, :pi],
                mz[j, :pj],
                intensity[j, :pj],
                fragment_mz_tolerance,
            )
            if n_match < min_matches:
                sim = 0.0
            out[k] = 1.0 - sim
            k += 1
    return out
