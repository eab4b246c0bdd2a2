"""What the program decides from the platform it runs on: the compile
cache's directory, the stated precision of threshold-compared products,
and the host library built from the tree."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from falcon_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_compile_cache_unset_goes_to_checkout(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = compile_cache.configure_compile_cache()
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_variable_wins(monkeypatch, tmp_path,
                                     restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else [value]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found.extend(_dot_precisions(inner))
    return found


def _ub_counts():
    from falcon_tpu.ops import pairwise

    x = jnp.ones((16, 8), jnp.float32)
    return jax.make_jaxpr(functools.partial(
        pairwise._ub_pass_counts, thr=0.5, panel=8))(x, x)


def _ub_topk():
    from falcon_tpu.ops import pairwise

    x = jnp.ones((16, 8), jnp.float32)
    return jax.make_jaxpr(functools.partial(
        pairwise._ub_pass_topk, thr=0.5, k=4, panel=8))(x, x)


def _banded_scan_f32():
    from falcon_tpu.ops import knn

    v = jnp.ones((16, 8), jnp.float32)
    return jax.make_jaxpr(functools.partial(
        knn._banded_topk, k=4, tol_is_da=True, block_rows=8, window=16,
        scan_bf16=False))(v, jnp.ones(16), jnp.zeros(2, jnp.int32),
                          jnp.float32(1.0))


def _sharded_scan():
    from jax.sharding import PartitionSpec as P

    from falcon_tpu.parallel.mesh import make_mesh
    from falcon_tpu.parallel.sharded_knn import _local_banded_topk

    mesh = make_mesh(2)
    fn = jax.shard_map(
        functools.partial(_local_banded_topk, axis="spectra", k=4,
                          tol_is_da=True, block_rows=8, window=16),
        mesh=mesh, in_specs=(P("spectra"), P("spectra"), P("spectra"), P()),
        out_specs=P("spectra"), check_vma=False)
    return jax.make_jaxpr(fn)(jnp.ones((32, 8)), jnp.ones(32),
                              jnp.zeros((2, 2), jnp.int32), jnp.float32(1.0))


def _medoid():
    from falcon_tpu.cluster import ann_engine

    ann_engine._medoid_scores(jnp.ones((8, 8)), np.zeros(8, np.int32), 1)
    return jax.make_jaxpr(functools.partial(
        ann_engine._medoid_scores_jit, n_seg_pad=256))(
            jnp.ones((512, 8)), jnp.zeros(512, jnp.int32))


def _sharded_medoid():
    from falcon_tpu.parallel import sharded_pipeline
    from falcon_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(2)
    sharded_pipeline.sharded_medoid_scores(
        jnp.ones((16, 8)), np.zeros(16, np.int32), 1, mesh)
    (fn,) = [f for key, f in sharded_pipeline._MEDOID_FNS.items()
             if key[0] == id(mesh)]
    return jax.make_jaxpr(fn)(jnp.ones((16, 8)), jnp.zeros(16, jnp.int32))


@pytest.mark.parametrize("build", [
    _ub_counts, _ub_topk, _banded_scan_f32, _sharded_scan, _medoid,
    _sharded_medoid,
], ids=lambda f: f.__name__.strip("_"))
def test_threshold_dots_run_at_highest_precision(build):
    """A GPU may run an f32 product in TF32 unless told otherwise; every
    product compared with a threshold states HIGHEST."""
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "no dot_general found"
    highest = (jax.lax.Precision.HIGHEST,) * 2
    assert all(p == highest for p in precisions), precisions


def test_native_library_rebuilds_when_a_source_is_newer(monkeypatch,
                                                        tmp_path):
    """The host library is rebuilt from the tree whenever a source is
    newer than it (a stale library from another host never loads)."""
    from falcon_tpu import native

    src = tmp_path / "a.cc"
    src.write_text("")
    lib = tmp_path / "libfalcon_native.so"
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    assert native._stale()  # missing
    lib.write_text("")
    os.utime(src, (1, 1))
    os.utime(lib, (2, 2))
    assert not native._stale()
    os.utime(src, (3, 3))
    assert native._stale()
