"""falcon-tpu: large-scale MS/MS spectrum clustering on an accelerator.

A brand-new framework with the capabilities of falcon
(https://github.com/bittremieux/falcon): it ingests mzML/mzXML/MGF peak
files on the host, preprocesses and L2-normalizes spectra, and
clusters them on the device (an NVIDIA GPU; the CPU for tests).  Two
similarity backends are provided behind one
interface:

- ``exact``: peak-matching cosine similarity (reference-faithful; cf.
  reference ``falcon/cluster/similarity.py:17-80``) computed as a Pallas/XLA
  kernel over padded peak arrays, followed by hierarchical clustering with
  the same ``fcluster(..., "distance")`` semantics as the reference
  (``falcon/cluster/cluster.py:280-290``).
- ``ann``: the published falcon algorithm — spectrum binning + MurmurHash3
  feature hashing to low-dimensional dense vectors, a from-scratch IVF
  nearest-neighbor index (k-means coarse quantizer on device, batched
  inner-product list scans with fused top-k), a precursor-tolerance-masked
  sparse distance matrix and density clustering.

The version string mirrors the reference's metadata plumbing
(``falcon/__init__.py:1-16``) but is defined statically because this
framework is developed in-tree.
"""

__version__ = "0.1.0"


def cluster_files(*args, **kwargs):
    """Public API entry point — see :func:`falcon_tpu.api.cluster`.

    Named ``cluster_files`` at package level because ``falcon_tpu.cluster``
    is the clustering subpackage; ``falcon_tpu.api.cluster`` is the same
    function.  Imported lazily so ``import falcon_tpu`` stays light
    (ingest worker processes import the package without pulling the
    pipeline driver).
    """
    from .api import cluster as _cluster

    return _cluster(*args, **kwargs)
