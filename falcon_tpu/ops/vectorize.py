"""Spectrum binning + feature hashing into dense device vectors.

Semantics of the published algorithm / the reference's (dead)
``to_vector`` / ``_to_vector`` (``falcon/cluster/spectrum.py:202-296``):
each peak is discretized to ``floor((mz - min_bound) / bin_size)``, every
bin is mapped to one output dimension by MurmurHash3 (``ops/hashing.py``),
intensities of peaks hashing to the same dimension accumulate, and the
resulting dense vector is L2-normalized for inner-product search.

The hot path is a device scatter-add: the padded (n, P) peak arrays
expand to per-peak hashed dimensions, and a scatter-add builds
(n, low_dim_padded) vectors directly in device memory.  ``low_dim`` is
padded to a multiple of 128 so downstream matmuls tile cleanly.
"""

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import binning_dims, hash_bin_mapping


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SpectrumHasher:
    """Precomputed binning + hashing configuration."""

    def __init__(
        self,
        min_mz: float,
        max_mz: float,
        bin_size: float,
        low_dim: int = 400,
        seed: int = 0,
    ):
        self.n_bins, self.min_bound, self.max_bound = binning_dims(
            min_mz, max_mz, bin_size
        )
        self.bin_size = float(bin_size)
        self.low_dim = int(low_dim)
        self.dim_padded = round_up(low_dim, 128)
        self.seed = int(seed)
        # bin -> hashed dim (host table, gathered on device).
        self.mapping = hash_bin_mapping(self.n_bins, low_dim, seed)

    def vectorize(
        self,
        mz: jnp.ndarray,
        intensity: jnp.ndarray,
        norm: bool = True,
        spread: bool = False,
    ) -> jnp.ndarray:
        """Padded (n, P) peaks -> (n, dim_padded) hashed dense vectors.

        Padding peaks (intensity 0) contribute nothing.  Peaks outside the
        binning range are dropped (the preprocessing m/z window already
        guarantees in-range peaks on the live path).

        ``spread=True`` additionally scatters each peak into its two
        neighboring bins (a [1, 1, 1] convolution in bin space BEFORE
        hashing).  With UNNORMALIZED vectors this yields a STRICT upper
        bound on the exact matched-peak score: a within-tolerance peak
        pair always lands in the same or adjacent bins (tolerance <= bin
        width), so ``spread_a . plain_b`` includes every within-tolerance
        intensity product, and hash collisions only add non-negative
        terms.  Used by the engine's prefilter (``cluster/ann_engine``).
        """
        if not spread:
            return _vectorize(
                mz, intensity, jnp.asarray(self.mapping),
                float(self.min_bound), self.bin_size, self.n_bins,
                self.dim_padded, bool(norm),
            )
        return _vectorize_spread(
            mz, intensity, jnp.asarray(self.mapping),
            float(self.min_bound), self.bin_size, self.n_bins,
            self.dim_padded, bool(norm),
        )


def vectorize_body(
    mz: jnp.ndarray,
    intensity: jnp.ndarray,
    mapping: jnp.ndarray,
    min_bound: float,
    bin_size: float,
    n_bins: int,
    dim_padded: int,
    norm: bool = True,
) -> jnp.ndarray:
    """Plain (unjitted) vectorization body — reused inside ``shard_map``
    by the multi-chip pipeline (``parallel/sharded_pipeline.py``)."""
    n, p = mz.shape
    bin_idx = jnp.floor((mz - min_bound) / bin_size).astype(jnp.int32)
    in_range = (bin_idx >= 0) & (bin_idx < n_bins) & (intensity > 0)
    bin_idx = jnp.clip(bin_idx, 0, n_bins - 1)
    dim_idx = mapping[bin_idx]
    # Out-of-range / padding peaks carry zero weight, so their scatter
    # target is irrelevant (bin_idx is clipped for index safety).
    weights = jnp.where(in_range, intensity, 0.0)
    vectors = jnp.zeros((n, dim_padded), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, p))
    vectors = vectors.at[rows.reshape(-1), dim_idx.reshape(-1)].add(
        weights.reshape(-1)
    )
    if norm:
        norms = jnp.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = vectors / jnp.maximum(norms, 1e-12)
    return vectors


_vectorize = functools.partial(
    jax.jit,
    static_argnames=("min_bound", "bin_size", "n_bins", "dim_padded",
                     "norm"),
)(vectorize_body)


@functools.partial(
    jax.jit,
    static_argnames=("min_bound", "bin_size", "n_bins", "dim_padded",
                     "norm"),
)
def _vectorize_spread(
    mz: jnp.ndarray,
    intensity: jnp.ndarray,
    mapping: jnp.ndarray,
    min_bound: float,
    bin_size: float,
    n_bins: int,
    dim_padded: int,
    norm: bool,
) -> jnp.ndarray:
    """Tolerance-spread variant: each peak scatters into bins
    {b-1, b, b+1} (edge bins drop the out-of-range neighbor)."""
    n, p = mz.shape
    bin_idx = jnp.floor((mz - min_bound) / bin_size).astype(jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, p))
    vectors = jnp.zeros((n, dim_padded), jnp.float32)
    for shift in (-1, 0, 1):
        b = bin_idx + shift
        in_range = (b >= 0) & (b < n_bins) & (intensity > 0)
        weights = jnp.where(in_range, intensity, 0.0)
        dim_idx = mapping[jnp.clip(b, 0, n_bins - 1)]
        vectors = vectors.at[rows.reshape(-1), dim_idx.reshape(-1)].add(
            weights.reshape(-1)
        )
    if norm:
        norms = jnp.linalg.norm(vectors, axis=1, keepdims=True)
        vectors = vectors / jnp.maximum(norms, 1e-12)
    return vectors
