import numpy as np
import jax.numpy as jnp
import pytest

import reference_impl

from falcon_tpu.cluster.oracle import cosine_exact, condensed_distances_exact
from falcon_tpu.ops.matching import pair_scores
from falcon_tpu.ops import pairwise
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import padded_peaks


@pytest.fixture(scope="module")
def padded_dataset():
    spectra, _ = make_clustered_spectra(
        n_clusters=12, cluster_size=4, n_noise=20, seed=3
    )
    rows = []
    for s in spectra:
        out = process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50, None)
        if out is not None:
            rows.append(out)
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz_flat = np.concatenate([r["mz"] for r in rows])
    int_flat = np.concatenate([r["intensity"] for r in rows])
    return padded_peaks(offsets, mz_flat, int_flat, 64)


def test_pair_scores_match_hungarian_oracle(padded_dataset):
    mz, intensity, lengths = padded_dataset
    rng = np.random.default_rng(0)
    n = len(lengths)
    pairs = rng.integers(0, n, size=(80, 2))
    approx, matches = pair_scores(
        jnp.asarray(mz[pairs[:, 0]]), jnp.asarray(intensity[pairs[:, 0]]),
        jnp.asarray(mz[pairs[:, 1]]), jnp.asarray(intensity[pairs[:, 1]]),
        0.05,
    )
    for k, (i, j) in enumerate(pairs):
        exact_score, exact_matches = cosine_exact(
            mz[i][: lengths[i]], intensity[i][: lengths[i]],
            mz[j][: lengths[j]], intensity[j][: lengths[j]], 0.05,
        )
        assert abs(float(approx[k]) - exact_score) < 1e-5
        assert int(matches[k]) == exact_matches


def test_self_similarity_is_one(padded_dataset):
    mz, intensity, lengths = padded_dataset
    score, matches = pair_scores(
        jnp.asarray(mz[:16]), jnp.asarray(intensity[:16]),
        jnp.asarray(mz[:16]), jnp.asarray(intensity[:16]), 0.05,
    )
    np.testing.assert_allclose(np.asarray(score), 1.0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(matches), lengths[:16])


def test_disjoint_spectra_score_zero():
    mz1 = np.full((1, 64), -1e6, np.float32)
    mz2 = np.full((1, 64), -1e6, np.float32)
    int1 = np.zeros((1, 64), np.float32)
    int2 = np.zeros((1, 64), np.float32)
    mz1[0, :3] = [100.0, 200.0, 300.0]
    int1[0, :3] = 0.6
    mz2[0, :3] = [150.0, 250.0, 350.0]
    int2[0, :3] = 0.6
    score, matches = pair_scores(
        jnp.asarray(mz1), jnp.asarray(int1),
        jnp.asarray(mz2), jnp.asarray(int2), 0.05,
    )
    assert float(score[0]) == 0.0
    assert int(matches[0]) == 0


def test_block_scores_xla_vs_oracle(padded_dataset):
    mz, intensity, lengths = padded_dataset
    sub = 24
    block_mz = jnp.asarray(mz[None, :sub])
    block_int = jnp.asarray(intensity[None, :sub])
    scores, matches = pairwise.panel_scores_xla(
        block_mz, block_int, block_mz, block_int, 0.05
    )
    scores = np.asarray(scores[0])
    exact = condensed_distances_exact(
        mz[:sub], intensity[:sub], lengths[:sub], 0.05, 0
    )
    iu = np.triu_indices(sub, k=1)
    np.testing.assert_allclose(1.0 - scores[iu], exact, atol=1e-5)
    # Symmetry.
    np.testing.assert_allclose(scores, scores.T, atol=1e-6)


def test_condensed_distances_pallas_interpret(padded_dataset):
    """The Pallas-Triton kernel (interpreter mode on CPU), streamed over
    the upper triangle, must agree with the Hungarian oracle."""
    mz, intensity, lengths = padded_dataset
    sub = 40
    dist = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, min_matches=0,
        backend="pallas_interpret", panel_rows=16,
    )
    exact = condensed_distances_exact(
        mz[:sub], intensity[:sub], lengths[:sub], 0.05, 0
    )
    np.testing.assert_allclose(dist, exact, atol=1e-5)


def test_condensed_distances_min_matches(padded_dataset):
    mz, intensity, lengths = padded_dataset
    sub = 20
    # With an absurd min_matches every distance collapses to 1.
    dist = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, min_matches=1000, backend="xla",
    )
    np.testing.assert_allclose(dist, 1.0)
    exact = condensed_distances_exact(
        mz[:sub], intensity[:sub], lengths[:sub], 0.05, 6
    )
    dist6 = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, min_matches=6, backend="xla",
    )
    np.testing.assert_allclose(dist6, exact, atol=1e-5)


def test_condensed_distances_xla_matches_pallas(padded_dataset):
    mz, intensity, _ = padded_dataset
    sub = 30
    d_xla = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, backend="xla"
    )
    d_pallas = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, backend="pallas_interpret",
        panel_rows=8,
    )
    np.testing.assert_allclose(d_xla, d_pallas, atol=1e-6)


def test_adversarial_dense_cost_matrices_bound():
    """Worst-case locally-dominant vs Hungarian gap on DENSE/ambiguous
    cost matrices (many near-equal products within tolerance) — the
    regime real tolerance-sparse spectra never enter.  The measured
    bound documents the kernel's failure mode honestly (README cites
    this test): with peaks crammed into one tolerance window and
    near-tied intensities, the matcher is greedy-like; its score is
    within a few percent of the Hungarian optimum and never above it.
    """
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(11)
    worst = 0.0
    for trial in range(60):
        p = int(rng.integers(8, 32))
        # All peaks within one tolerance window of each other -> fully
        # dense cost matrix; near-equal intensities maximize ambiguity.
        mz_a = np.sort(500.0 + rng.uniform(0, 0.04, p)).astype(np.float32)
        mz_b = np.sort(500.0 + rng.uniform(0, 0.04, p)).astype(np.float32)
        int_a = (1.0 + rng.uniform(0, 0.05, p)).astype(np.float32)
        int_b = (1.0 + rng.uniform(0, 0.05, p)).astype(np.float32)
        int_a /= np.linalg.norm(int_a)
        int_b /= np.linalg.norm(int_b)
        pad = 64
        mz_pa = np.full(pad, pairwise.PAD_MZ, np.float32)
        mz_pb = np.full(pad, pairwise.PAD_MZ, np.float32)
        in_a = np.zeros(pad, np.float32)
        in_b = np.zeros(pad, np.float32)
        mz_pa[:p], mz_pb[:p] = mz_a, mz_b
        in_a[:p], in_b[:p] = int_a, int_b
        got, _ = pair_scores(
            jnp.asarray(mz_pa[None]), jnp.asarray(in_a[None]),
            jnp.asarray(mz_pb[None]), jnp.asarray(in_b[None]),
            0.05, rounds=32,
        )
        got = float(got[0])
        w = np.where(
            np.abs(mz_a[:, None] - mz_b[None, :]) <= 0.05,
            int_a[:, None] * int_b[None, :], 0.0,
        )
        ri, ci = linear_sum_assignment(-w)
        hungarian = float(np.clip(w[ri, ci].sum(), 0.0, 1.0))
        assert got <= hungarian + 1e-5  # never overshoots the optimum
        worst = max(worst, hungarian - got)
    # Measured worst-case deficit on fully-dense ambiguous matrices.
    # (README's accuracy claim is calibrated to this bound.)
    assert worst <= 0.05, worst


def _reference_condensed(mz, intensity, lengths, min_matches):
    """Condensed distances from the reference's own cosine_fast
    (tests/reference_impl.py), with its min_matches rule."""
    n = len(lengths)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            score, matched = reference_impl.cosine_fast(
                mz[i][: lengths[i]], intensity[i][: lengths[i]],
                mz[j][: lengths[j]], intensity[j][: lengths[j]], 0.05,
            )
            out.append(1.0 - (score if matched >= min_matches else 0.0))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("panel_rows", [8, 16, 64])
@pytest.mark.parametrize("min_matches", [0, 6])
def test_streamed_condensed_xla_vs_reference(padded_dataset, panel_rows,
                                             min_matches):
    """The XLA path streams row panels over the upper triangle (columns
    from the panel's first row on); every panel size gives the
    reference's condensed matrix."""
    mz, intensity, lengths = padded_dataset
    sub = 37  # not a multiple of any panel: a ragged last panel
    dist = pairwise.condensed_distances(
        mz[:sub], intensity[:sub], 0.05, min_matches=min_matches,
        panel_rows=panel_rows, backend="xla",
    )
    ref = _reference_condensed(mz[:sub], intensity[:sub], lengths[:sub],
                               min_matches)
    np.testing.assert_allclose(dist, ref, atol=1e-5)


@pytest.mark.parametrize("upper_only", [False, True])
@pytest.mark.parametrize("rows,cols", [(8, 32), (16, 16)])
def test_panel_kernel_matches_xla(padded_dataset, upper_only, rows, cols):
    """The Triton kernel (interpreted) and the XLA reference agree on
    scores and match counts, including the zeroed below-diagonal part
    of an upper-only panel."""
    mz, intensity, _ = padded_dataset
    args = (jnp.asarray(mz[None, :rows]), jnp.asarray(intensity[None, :rows]),
            jnp.asarray(mz[None, :cols]), jnp.asarray(intensity[None, :cols]))
    s_k, m_k = pairwise.panel_scores(*args, 0.05, upper_only=upper_only,
                                     backend="pallas_interpret")
    s_x, m_x = pairwise.panel_scores(*args, 0.05, upper_only=upper_only,
                                     backend="xla")
    np.testing.assert_allclose(np.asarray(s_k), np.asarray(s_x), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(m_k), np.asarray(m_x))
    if upper_only:
        below = np.tril(np.ones((rows, cols), bool))
        assert not np.asarray(s_k)[0][below].any()
        assert np.asarray(s_k)[0][~below].any()


def test_panel_kernel_pads_peaks_to_power_of_two(padded_dataset):
    """P = 48 is padded to 64 for the kernel (Triton tensors have
    power-of-two sides); the scores do not change."""
    mz, intensity, _ = padded_dataset
    assert (mz[:16, 48:] == pairwise.PAD_MZ).all()  # <= 48 real peaks
    args = (jnp.asarray(mz[None, :16, :48]),
            jnp.asarray(intensity[None, :16, :48]))
    s_k, _ = pairwise.panel_scores(*args, *args, 0.05,
                                   backend="pallas_interpret")
    s_x, _ = pairwise.panel_scores(*args, *args, 0.05, backend="xla")
    assert s_k.shape == (1, 16, 16)
    np.testing.assert_allclose(np.asarray(s_k), np.asarray(s_x), atol=1e-6)


def test_grouped_condensed_kernel_matches_oracle(padded_dataset):
    """Small intervals bucketed into size classes and scored as one
    batched upper-only panel through the kernel (interpreted)."""
    mz, intensity, lengths = padded_dataset
    bounds = [(0, 5), (5, 14), (14, 17), (17, 30)]
    intervals = [(mz[a:b], intensity[a:b]) for a, b in bounds]
    got = dict(pairwise.grouped_condensed_distances(
        intervals, 0.05, backend="pallas_interpret"))
    for idx, (a, b) in enumerate(bounds):
        ref = condensed_distances_exact(mz[a:b], intensity[a:b],
                                        lengths[a:b], 0.05, 0)
        np.testing.assert_allclose(got[idx], ref, atol=1e-5)


def test_panel_backend_follows_platform(monkeypatch):
    """A GPU process selects the compiled kernel, any other platform
    the XLA code; an unknown backend name is an error."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pairwise.panel_impl() == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert pairwise.panel_impl() == "xla"
    calls = []
    monkeypatch.setattr(pairwise, "panel_scores_xla",
                        lambda *a, **k: calls.append(a) or (None, None))
    pairwise.panel_scores(*(np.zeros((1, 8, 64), np.float32),) * 4, 0.05)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="unknown pair-panel backend"):
        pairwise.panel_scores(*(np.zeros((1, 8, 64), np.float32),) * 4,
                              0.05, backend="mosaic")


@pytest.mark.gpu
def test_panel_kernel_compiled_on_gpu(padded_dataset):
    """On a GPU the default is the compiled kernel, equal to XLA."""
    mz, intensity, _ = padded_dataset
    args = (jnp.asarray(mz[None, :32]), jnp.asarray(intensity[None, :32]))
    assert pairwise.panel_impl() == "pallas"
    s_k, m_k = pairwise.panel_scores(*args, *args, 0.05, upper_only=True)
    s_x, m_x = pairwise.panel_scores(*args, *args, 0.05, upper_only=True,
                                     backend="xla")
    np.testing.assert_allclose(np.asarray(s_k), np.asarray(s_x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(m_k), np.asarray(m_x))
