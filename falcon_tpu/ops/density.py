"""Density clustering (DBSCAN) as device label propagation.

The published falcon algorithm runs DBSCAN over the sparse k-NN distance
matrix (reference ``README.md:132-142``).  Device design: core-point
detection and the connected components of the core-core eps-graph run
entirely on device — components via iterative min-label propagation over
the (n, k) neighbor lists (gather for out-edges, scatter-min for
in-edges, so the asymmetric top-k lists behave as an undirected graph),
a ``lax.while_loop`` until fixpoint.  The host fetches three compact
arrays (component label, core flag, best-core-neighbor id — a few MB at
n = millions) instead of the full similarity/neighbor matrices
(hundreds of MB).

Semantics match the host reference implementation exactly
(tests/test_density.py): core = >= min_samples points within eps
(including self); clusters = connected components over core-core edges;
border points attach to their most-similar core neighbor within eps;
components left with < 2 members become noise.
"""

import functools
from typing import Tuple

import numpy as np


_dbscan_jit = None


def _get_kernel():
    global _dbscan_jit
    if _dbscan_jit is not None:
        return _dbscan_jit
    import jax
    import jax.numpy as jnp

    from .knn import NEG

    @functools.partial(jax.jit, static_argnames=("min_samples",))
    def kernel(sims, neigh, eps, n, min_samples):
        # ``n`` is traced (a scalar array) so the kernel compiles once
        # per PADDED shape, not once per exact dataset size.
        n_pad, k = sims.shape
        row = jnp.arange(n_pad, dtype=jnp.int32)
        in_range = row < n
        valid = (neigh >= 0) & in_range[:, None]
        within = valid & ((1.0 - sims) <= eps)
        neigh_safe = jnp.clip(neigh, 0, n_pad - 1)
        n_within = within.sum(axis=1) + 1
        core = (n_within >= min_samples) & in_range
        edge = within & core[:, None] & core[neigh_safe]

        def cond(state):
            _, changed, it = state
            return jnp.logical_and(changed, it < n_pad)

        def body(state):
            labels, _, it = state
            # Out-edges: gather neighbor labels.
            neigh_labels = jnp.where(edge, labels[neigh_safe], n_pad)
            new = jnp.minimum(labels, jnp.min(neigh_labels, axis=1))
            # In-edges: scatter-min own label to neighbors (dump slot
            # n_pad for non-edges).
            tgt = jnp.where(edge, neigh_safe, n_pad)
            padded = jnp.concatenate(
                [new, jnp.full((1,), n_pad, new.dtype)]
            )
            padded = padded.at[tgt.reshape(-1)].min(
                jnp.broadcast_to(labels[:, None], (n_pad, k)).reshape(-1)
            )
            new = padded[:n_pad]
            # Pointer jumping: a label is a row id, so label[label[x]]
            # is also x's component — two cheap gathers shortcut long
            # chains, making convergence O(log diameter) instead of
            # O(diameter) expensive edge sweeps.
            safe = jnp.minimum(new, n_pad - 1)
            new = jnp.minimum(new, new[safe])
            safe = jnp.minimum(new, n_pad - 1)
            new = jnp.minimum(new, new[safe])
            return new, jnp.any(new != labels), it + 1

        labels0 = jnp.where(core, row, jnp.int32(n_pad))
        labels, _, n_iters = jax.lax.while_loop(
            cond, body, (labels0, jnp.bool_(True), jnp.int32(0))
        )
        comp = jnp.where(core, labels, -1)

        # Border points: most-similar core neighbor within eps.
        core_neigh = within & core[neigh_safe]
        best_pos = jnp.argmax(
            jnp.where(core_neigh, sims, NEG), axis=1
        )
        best_id = jnp.take_along_axis(
            neigh, best_pos[:, None], axis=1
        )[:, 0]
        has_core = core_neigh.any(axis=1)
        border_attach = jnp.where(
            has_core & ~core & in_range, best_id, -1
        )
        return comp, core, border_attach, n_iters

    _dbscan_jit = kernel
    return kernel


def dbscan(
    sims,
    neigh,
    eps: float,
    n: int,
    min_samples: int,
) -> np.ndarray:
    """DBSCAN labels for n rows; -1 marks noise.

    ``sims``/``neigh``: (n or n_pad, k) similarity / neighbor-id arrays,
    NumPy or device-resident (pass the rerank stage's device output to
    avoid any large transfer).  Components are numbered by first
    occurrence; components with < 2 members become noise.
    """
    import jax.numpy as jnp

    if isinstance(sims, np.ndarray):
        n_pad = 512
        while n_pad < n:
            n_pad *= 2
        s = np.full((n_pad, sims.shape[1]), -2.0, np.float32)
        s[:n] = sims
        g = np.full((n_pad, neigh.shape[1]), -1, np.int32)
        g[:n] = neigh
        sims, neigh = jnp.asarray(s), jnp.asarray(g)
    comp, core, border_attach, _ = _get_kernel()(
        sims, jnp.asarray(neigh, jnp.int32), jnp.float32(eps),
        jnp.int32(n), int(min_samples),
    )
    return labels_from_parts(
        np.asarray(comp)[:n], np.asarray(core)[:n],
        np.asarray(border_attach)[:n], n,
    )


def labels_from_parts(
    comp: np.ndarray, core: np.ndarray, border_attach: np.ndarray, n: int
) -> np.ndarray:
    """Host renumbering of the device kernel's compact outputs.

    Shared by the single-device path above and the multi-chip pipeline
    (``parallel/sharded_pipeline.py``) so both produce identical labels
    from identical (comp, core, border) parts.
    """
    # Renumber core components by first occurrence.
    labels = np.full(n, -1, np.int64)
    if core.any():
        uniq, inverse = np.unique(comp[core], return_inverse=True)
        # np.unique sorts by component id == min member row == first
        # occurrence order (rows are scanned in order).
        labels[core] = inverse
    # Border attachment.
    attach = border_attach >= 0
    labels[attach] = labels[border_attach[attach]]
    # Drop single-member components to noise.
    uniq, counts = np.unique(labels[labels >= 0], return_counts=True)
    singles = uniq[counts < 2]
    if len(singles):
        labels[np.isin(labels, singles)] = -1
    return labels
