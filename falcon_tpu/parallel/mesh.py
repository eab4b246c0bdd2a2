"""Multi-chip sharding of the clustering pipeline.

The reference is a single-node CPU tool with zero distributed
communication (SURVEY.md §2.4); its data layout nevertheless dictates the
multi-chip strategy: charge buckets and precursor-m/z intervals are
embarrassingly parallel, and *within* a large interval the work is
all-pairs/all-neighbors over row panels.  The plan implemented
here:

- a 1-D device mesh over the ``spectra`` axis (data parallelism over
  sorted spectrum rows);
- vectorization runs fully local (rows sharded);
- the spherical k-means quantizer update is a data-parallel
  ``psum`` of per-device one-hot sums — the classic gradient-allreduce
  pattern, riding ICI;
- neighbor search all-gathers the (much smaller) hashed vectors so each
  device scores its row panel against the full candidate set — the
  tensor-parallel all-gather pattern;
- the exact peak-matching kernel scores each device's row panel against
  the all-gathered peak arrays (sequence-parallel-style blockwise tiles,
  fixing the reference's dropped cross-chunk pairs, SURVEY.md §5-g).

Everything is expressed with ``shard_map`` + named collectives so XLA
schedules the communication; no NCCL/MPI translation anywhere.
"""

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.matching import pair_weights, match_score


def make_mesh(n_devices: Optional[int] = None, axis: str = "spectra"
              ) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_rows(mesh: Mesh, array, axis: str = "spectra"):
    """Place an array with its leading axis sharded over the mesh."""
    return jax.device_put(
        array, NamedSharding(mesh, P(axis))
    )


def _local_step(
    mz_peaks,       # (n_local, P) padded peak m/z
    int_peaks,      # (n_local, P) padded, L2-normalized intensities
    precursor_mz,   # (n_local,)
    mapping,        # (n_bins,) hashed bin -> dim (replicated)
    centroids,      # (n_lists, D) (replicated)
    *,
    axis: str,
    min_bound: float,
    bin_size: float,
    n_bins: int,
    dim_padded: int,
    fragment_tol: float,
    precursor_tol_mass: float,
    tol_is_da: bool,
    k: int,
    exact_rows: int,
):
    n_local, p = mz_peaks.shape
    n_lists = centroids.shape[0]
    my_index = jax.lax.axis_index(axis)

    # 1. Vectorize locally (rows sharded; no communication).
    raw_bin = jnp.floor((mz_peaks - min_bound) / bin_size).astype(jnp.int32)
    bin_idx = jnp.clip(raw_bin, 0, n_bins - 1)
    in_range = (raw_bin >= 0) & (raw_bin < n_bins) & (int_peaks > 0)
    weights = jnp.where(in_range, int_peaks, 0.0)
    dim_idx = mapping[bin_idx]
    vectors = jnp.zeros((n_local, dim_padded), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(n_local)[:, None], (n_local, p))
    vectors = vectors.at[rows.reshape(-1), dim_idx.reshape(-1)].add(
        weights.reshape(-1)
    )
    vectors = vectors / jnp.maximum(
        jnp.linalg.norm(vectors, axis=1, keepdims=True), 1e-12
    )

    # 2. k-means quantizer update: local partial sums + psum over the
    # mesh (data-parallel allreduce over ICI).
    sims_c = jnp.dot(vectors, centroids.T,
                     preferred_element_type=jnp.float32)
    one_hot = jax.nn.one_hot(jnp.argmax(sims_c, axis=1), n_lists,
                             dtype=jnp.float32)
    sums = jax.lax.psum(
        jnp.dot(one_hot.T, vectors, preferred_element_type=jnp.float32),
        axis,
    )
    counts = jax.lax.psum(jnp.sum(one_hot, axis=0), axis)
    new_centroids = jnp.where(counts[:, None] > 0, sums, centroids)
    new_centroids = new_centroids / jnp.maximum(
        jnp.linalg.norm(new_centroids, axis=1, keepdims=True), 1e-12
    )

    # 3. Neighbor search: all-gather the hashed vectors (small), score the
    # local row panel against the full set, fused top-k.
    all_vectors = jax.lax.all_gather(vectors, axis, tiled=True)
    all_pmz = jax.lax.all_gather(precursor_mz, axis, tiled=True)
    sims = jnp.dot(vectors, all_vectors.T,
                   preferred_element_type=jnp.float32)
    diff = precursor_mz[:, None] - all_pmz[None, :]
    if tol_is_da:
        mass_diff = jnp.abs(diff)
    else:
        mass_diff = jnp.abs(diff / all_pmz[None, :] * 1e6)
    global_row = my_index * n_local + jnp.arange(n_local)
    not_self = global_row[:, None] != jnp.arange(all_pmz.shape[0])[None, :]
    sims = jnp.where((mass_diff <= precursor_tol_mass) & not_self,
                     sims, -2.0)
    top_scores, top_idx = jax.lax.top_k(sims, k)

    # 4. Exact peak-matching tile: local rows (subsampled to exact_rows)
    # vs the all-gathered peak arrays — the Pallas kernel's semantics in
    # portable XLA form (used by the dryrun; on hardware the Pallas panel
    # kernel runs per shard instead).
    all_mz_peaks = jax.lax.all_gather(mz_peaks, axis, tiled=True)
    all_int_peaks = jax.lax.all_gather(int_peaks, axis, tiled=True)
    w = pair_weights(
        mz_peaks[:exact_rows][:, None, :],
        int_peaks[:exact_rows][:, None, :],
        all_mz_peaks[None, :, :],
        all_int_peaks[None, :, :],
        fragment_tol,
    )
    exact_scores, _ = match_score(w)

    return new_centroids, top_scores, top_idx, exact_scores


def multichip_cluster_step(
    mesh: Mesh,
    mz_peaks: np.ndarray,
    int_peaks: np.ndarray,
    precursor_mz: np.ndarray,
    mapping: np.ndarray,
    centroids: np.ndarray,
    min_bound: float,
    bin_size: float,
    n_bins: int,
    fragment_tol: float = 0.05,
    precursor_tol_mass: float = 20.0,
    precursor_tol_mode: str = "ppm",
    k: int = 8,
    exact_rows: int = 8,
    axis: str = "spectra",
):
    """One jitted multi-chip clustering step over the mesh.

    Rows (spectra) are sharded over the mesh axis; the hash mapping and
    k-means centroids are replicated.  Returns (updated centroids
    [replicated], top-k scores/indices [row-sharded], exact pair-score
    sample [row-sharded]).
    """
    n, p = mz_peaks.shape
    dim_padded = centroids.shape[1]
    local = functools.partial(
        _local_step,
        axis=axis,
        min_bound=float(min_bound),
        bin_size=float(bin_size),
        n_bins=int(n_bins),
        dim_padded=int(dim_padded),
        fragment_tol=float(fragment_tol),
        precursor_tol_mass=float(precursor_tol_mass),
        tol_is_da=precursor_tol_mode == "Da",
        k=int(k),
        exact_rows=int(exact_rows),
    )
    step = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P()),
            out_specs=(P(), P(axis), P(axis), P(axis)),
            check_vma=False,
        )
    )
    return step(
        jnp.asarray(mz_peaks, jnp.float32),
        jnp.asarray(int_peaks, jnp.float32),
        jnp.asarray(precursor_mz, jnp.float32),
        jnp.asarray(mapping, jnp.int32),
        jnp.asarray(centroids, jnp.float32),
    )
