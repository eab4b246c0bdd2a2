import numpy as np
import jax.numpy as jnp
import pytest

from falcon_tpu.ops.hashing import murmurhash3_32, hash_bin_mapping
from falcon_tpu.ops.vectorize import SpectrumHasher
from falcon_tpu.ops.knn import knn_banded
from falcon_tpu.cluster import ann_engine
from falcon_tpu.preprocess import process_spectrum
from falcon_tpu.simulate import make_clustered_spectra
from falcon_tpu.store.store import SpectrumStore, padded_peaks


def test_murmurhash3_known_values():
    # Reference values from the canonical MurmurHash3_x86_32 of the
    # 4-byte little-endian integer encodings.
    assert murmurhash3_32(np.array([0]), 0)[0] == 0x2362F9DE
    # Determinism + seed sensitivity + spread.
    h1 = murmurhash3_32(np.arange(1000), 0)
    h2 = murmurhash3_32(np.arange(1000), 0)
    h3 = murmurhash3_32(np.arange(1000), 42)
    np.testing.assert_array_equal(h1, h2)
    assert (h1 != h3).any()
    assert len(np.unique(h1 % 400)) > 350  # near-uniform over 400 dims


def test_hash_mapping_stable():
    m1 = hash_bin_mapping(27981, 400, 0)
    m2 = hash_bin_mapping(27981, 400, 0)
    np.testing.assert_array_equal(m1, m2)
    assert m1.min() >= 0 and m1.max() < 400


@pytest.fixture(scope="module")
def processed_rows():
    spectra, truth = make_clustered_spectra(
        n_clusters=20, cluster_size=6, n_noise=40, seed=33, charges=(2,),
    )
    rows, kept = [], []
    for s, t in zip(spectra, truth):
        out = process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50,
                               None)
        if out is not None:
            rows.append(out)
            kept.append(t)
    return rows, np.asarray(kept)


def _padded(rows):
    offsets = np.zeros(len(rows) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    mz_flat = np.concatenate([r["mz"] for r in rows])
    int_flat = np.concatenate([r["intensity"] for r in rows])
    return padded_peaks(offsets, mz_flat, int_flat, 64)


def test_vectorize_matches_direct_binning(processed_rows):
    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, lengths = _padded(rows[:32])
    vectors = np.asarray(
        hasher.vectorize(jnp.asarray(mz), jnp.asarray(intensity))
    )
    # Direct host reference: bin each real peak, accumulate, normalize.
    for i in range(8):
        ref = np.zeros(hasher.dim_padded, np.float32)
        for mz_p, int_p in zip(mz[i][: lengths[i]],
                               intensity[i][: lengths[i]]):
            b = int(np.floor((mz_p - hasher.min_bound) / hasher.bin_size))
            ref[hasher.mapping[b]] += int_p
        ref /= np.linalg.norm(ref)
        np.testing.assert_allclose(vectors[i], ref, atol=1e-6)
    # Unit norm; nothing outside low_dim.
    np.testing.assert_allclose(
        np.linalg.norm(vectors, axis=1), 1.0, atol=1e-5
    )
    assert np.abs(vectors[:, 400:]).max() == 0.0


def test_knn_banded_exact_within_band(processed_rows):
    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, _ = _padded(rows)
    vectors = np.asarray(
        hasher.vectorize(jnp.asarray(mz), jnp.asarray(intensity))
    )
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    vectors, pmz = vectors[order], pmz[order]
    k = 8
    sims, neigh = knn_banded(vectors, pmz, 20.0, "ppm", k, block_rows=64)
    # Brute-force reference.
    full = vectors @ vectors.T
    n = len(pmz)
    for i in range(n):
        mask = np.abs((pmz[i] - pmz) / pmz * 1e6) <= 20.0
        mask[i] = False
        cand = np.flatnonzero(mask)
        got = neigh[i][neigh[i] >= 0]
        want = cand[np.argsort(-full[i, cand], kind="stable")][:k]
        assert len(got) == min(k, len(cand))
        # Same similarity multiset (ties can reorder indices).
        np.testing.assert_allclose(
            np.sort(sims[i][: len(got)])[::-1],
            np.sort(full[i, want])[::-1],
            atol=1e-5,
        )


def test_knn_banded_exact_topk_flag(processed_rows):
    """exact_topk=True (used when no rerank stage runs) must return the
    true top-k per row, not approx_max_k's recall<1 candidates."""
    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, _ = _padded(rows)
    vectors = np.asarray(
        hasher.vectorize(jnp.asarray(mz), jnp.asarray(intensity))
    )
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    vectors, pmz = vectors[order], pmz[order]
    k = 8
    sims, neigh = knn_banded(vectors, pmz, 20.0, "ppm", k, block_rows=64,
                             exact_topk=True)
    full = vectors @ vectors.T
    n = len(pmz)
    for i in range(n):
        mask = np.abs((pmz[i] - pmz) / pmz * 1e6) <= 20.0
        mask[i] = False
        cand = np.flatnonzero(mask)
        got = neigh[i][neigh[i] >= 0]
        want = cand[np.argsort(-full[i, cand], kind="stable")][:k]
        assert len(got) == min(k, len(cand))
        np.testing.assert_allclose(
            np.sort(sims[i][: len(got)])[::-1],
            np.sort(full[i, want])[::-1],
            atol=1e-5,
        )


def test_spread_vectors_upper_bound(processed_rows):
    """The tolerance-spread prefilter bound is STRICT: for every pair,
    spread_a . plain_b >= the exact matched-peak cosine.  This is the
    invariant that makes the engine's prefiltered labels identical to
    full exact reranking."""
    from falcon_tpu.cluster.oracle import cosine_exact

    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, _ = _padded(rows)
    plain = np.asarray(hasher.vectorize(
        jnp.asarray(mz), jnp.asarray(intensity), norm=False
    ))
    spread = np.asarray(hasher.vectorize(
        jnp.asarray(mz), jnp.asarray(intensity), norm=False, spread=True
    ))
    rng = np.random.default_rng(3)
    n = len(rows)
    for _ in range(300):
        i, j = rng.integers(0, n, 2)
        ub = float(spread[i] @ plain[j])
        exact, _ = cosine_exact(
            mz[i][mz[i] > 0], intensity[i][mz[i] > 0],
            mz[j][mz[j] > 0], intensity[j][mz[j] > 0], 0.05,
        )
        assert ub >= exact - 1e-5, (i, j, ub, exact)


def test_engine_prefilter_matches_exhaustive_dbscan(processed_rows,
                                                    tmp_path):
    """Engine labels (upper-bound prefilter + exact rerank) equal a
    DBSCAN built from EXHAUSTIVE exact in-band scoring."""
    from falcon_tpu.cluster import ann_engine
    from falcon_tpu.cluster.oracle import cosine_exact
    from falcon_tpu.ops.density import dbscan
    from falcon_tpu.store.store import SpectrumStore

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    eps, min_samples = 0.1, 2
    labels_engine, _ = ann_engine.generate_clusters(
        ds, eps=eps, min_samples=min_samples, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15, cluster_method="dbscan",
    )

    # Oracle: exhaustive exact scores within the band -> DBSCAN with the
    # same (k-truncation-free) neighbor lists, then the same refinement.
    meta = ds.read_metadata()
    pmz = np.asarray(meta["precursor_mz"], np.float64)
    order = np.argsort(pmz, kind="stable")
    mz, intensity, _ = _padded([rows[i] for i in order])
    pmz_s = pmz[order]
    n = len(pmz_s)
    k = 64
    sims = np.full((n, k), -2.0, np.float32)
    neigh = np.full((n, k), -1, np.int64)
    for i in range(n):
        mask = np.abs((pmz_s[i] - pmz_s) / pmz_s * 1e6) <= 20.0
        mask[i] = False
        cand = np.flatnonzero(mask)
        scores = np.array([
            cosine_exact(
                mz[i][mz[i] > 0], intensity[i][mz[i] > 0],
                mz[j][mz[j] > 0], intensity[j][mz[j] > 0], 0.05,
            )[0]
            for j in cand
        ])
        top = np.argsort(-scores, kind="stable")[:k]
        sims[i, : len(top)] = scores[top]
        neigh[i, : len(top)] = cand[top]
    raw = dbscan(sims, neigh, eps, n, min_samples)
    # Engine returns labels in dataset row order with noise promoted to
    # singletons; compare CLUSTER PARTITIONS over the non-singleton part.
    raw_roworder = np.empty(n, np.int64)
    raw_roworder[order] = raw
    from falcon_tpu import metrics

    multi = np.flatnonzero(raw_roworder >= 0)
    assert metrics.cluster_purity(
        labels_engine[multi], raw_roworder[multi]) == 1.0
    assert metrics.cluster_completeness(
        labels_engine[multi], raw_roworder[multi]) >= 0.999


def test_exact_banded_topk_backends(processed_rows):
    """The exact banded search returns the true exact-cosine top-k: its
    in-band scores equal the pair-panel kernel's (Triton, interpreted)
    on the same pairs, and the Hungarian oracle's."""
    from falcon_tpu.cluster.oracle import cosine_exact
    from falcon_tpu.ops import pairwise
    from falcon_tpu.ops.exact_knn import exact_banded_topk
    from falcon_tpu.ops.pairwise import PAD_MZ

    rows, _ = processed_rows
    mz, intensity, _ = _padded(rows)
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    mz, intensity, pmz = mz[order], intensity[order], pmz[order]
    n = len(pmz)
    n_pad = 512
    while n_pad < n:
        n_pad *= 2
    mz_pad = np.full((n_pad, mz.shape[1]), PAD_MZ, np.float32)
    int_pad = np.zeros((n_pad, mz.shape[1]), np.float32)
    mz_pad[:n], int_pad[:n] = mz, intensity
    k = 8
    results = {}
    sims, neigh = exact_banded_topk(
        jnp.asarray(mz_pad), jnp.asarray(int_pad), pmz, 20.0, "ppm",
        k, 0.05,
    )
    results["xla"] = (np.asarray(sims)[:n], np.asarray(neigh)[:n])
    # The kernel scores only the rows with a real band, against all
    # columns; the banded top-k lists must read the same scores.
    sims, neigh = results["xla"]
    rows_k = np.flatnonzero((neigh >= 0).any(axis=1))[:16]
    n_cols = 1 << max(4, int(n - 1).bit_length())
    cols_mz = np.full((n_cols, mz.shape[1]), PAD_MZ, np.float32)
    cols_int = np.zeros((n_cols, mz.shape[1]), np.float32)
    cols_mz[:n], cols_int[:n] = mz, intensity
    panel, _ = pairwise.panel_scores(
        jnp.asarray(mz_pad[None, rows_k]), jnp.asarray(int_pad[None, rows_k]),
        jnp.asarray(cols_mz[None]), jnp.asarray(cols_int[None]), 0.05,
        rounds=4, backend="pallas_interpret",
    )
    panel = np.asarray(panel[0])
    for r, i in enumerate(rows_k):
        got = neigh[i] >= 0
        np.testing.assert_allclose(
            sims[i][got], panel[r][neigh[i][got]], atol=1e-5)
    # Oracle: exact matching cosine per pair within the band.
    sims, neigh = results["xla"]
    for i in range(0, n, 7):
        mask = np.abs((pmz[i] - pmz) / pmz * 1e6) <= 20.0
        mask[i] = False
        cand = np.flatnonzero(mask)
        exact = np.array([
            cosine_exact(
                mz[i][mz[i] > 0], intensity[i][mz[i] > 0],
                mz[j][mz[j] > 0], intensity[j][mz[j] > 0], 0.05,
            )[0]
            for j in cand
        ])
        got = sims[i][neigh[i] >= 0]
        want = np.sort(exact)[::-1][: len(got)]
        assert len(got) == min(k, len(cand))
        np.testing.assert_allclose(np.sort(got)[::-1], want, atol=5e-3)


def test_ann_engine_end_to_end(processed_rows, tmp_path):
    rows, truth = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    dataset = store.dataset(2)
    labels, medoids = ann_engine.generate_clusters(
        dataset, eps=0.3, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15, low_dim=400, n_neighbors=16,
        min_mz=101.0, max_mz=1500.0, max_peaks=50,
    )
    assert len(labels) == len(rows)
    assert (labels >= 0).all()
    assert len(medoids) == len(np.unique(labels))
    # Purity vs ground truth.
    purity_num = sum(
        np.bincount(truth[labels == lab]).max()
        for lab in np.unique(labels)
    )
    assert purity_num / len(truth) > 0.95
    # Completeness: the 20 true clusters should mostly be recovered.
    from collections import Counter

    comp = sum(
        Counter(labels[truth == t]).most_common(1)[0][1]
        for t in np.unique(truth)
    ) / len(truth)
    # The simulator's jitter puts some true members past eps=0.3 in
    # hashed-cosine space; purity is the strict gate above.
    assert comp > 0.8


def test_ann_vs_exact_nn_recall(processed_rows):
    """NN recall@k of hashed vectors vs the exact peak-matching cosine
    ranking (the BASELINE.json quality metric)."""
    from falcon_tpu.cluster.oracle import cosine_exact

    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, lengths = _padded(rows)
    vectors = np.asarray(
        hasher.vectorize(jnp.asarray(mz), jnp.asarray(intensity))
    )
    hashed_sims = vectors @ vectors.T
    n = len(rows)
    rng = np.random.default_rng(0)
    hits = total = 0
    k = 5
    for i in rng.choice(n, 25, replace=False):
        exact = np.array([
            cosine_exact(mz[i][: lengths[i]], intensity[i][: lengths[i]],
                         mz[j][: lengths[j]], intensity[j][: lengths[j]],
                         0.05)[0]
            if j != i else -1.0
            for j in range(n)
        ])
        want = set(np.argsort(-exact, kind="stable")[:k][exact[
            np.argsort(-exact, kind="stable")[:k]] > 0.2].tolist())
        if not want:
            continue
        got_order = np.argsort(-hashed_sims[i], kind="stable")
        got = set(got_order[got_order != i][:k].tolist())
        hits += len(want & got)
        total += len(want)
    assert total > 0
    recall = hits / total
    assert recall >= 0.9, recall


def test_ann_engine_ivf_path(processed_rows, tmp_path):
    """The IVF index path produces the same high-purity clustering."""
    rows, truth = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra_ivf"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    dataset = store.dataset(2)
    labels, medoids = ann_engine.generate_clusters(
        dataset, eps=0.3, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15, low_dim=400, n_neighbors=16,
        n_neighbors_ann=32, n_probe=8,
        min_mz=101.0, max_mz=1500.0, max_peaks=50, use_ivf=True,
    )
    assert (labels >= 0).all()
    purity_num = sum(
        np.bincount(truth[labels == lab]).max()
        for lab in np.unique(labels)
    )
    assert purity_num / len(truth) > 0.95


def test_knn_banded_as_device_matches_host():
    import jax.numpy as jnp_

    rng = np.random.default_rng(3)
    n, d = 700, 128
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    mzs = np.sort(rng.uniform(400, 1200, n))
    k = 8
    host_s, host_i = knn_banded(vectors, mzs, 20.0, "ppm", k)
    dev_s, dev_i = knn_banded(jnp_.asarray(vectors), mzs, 20.0, "ppm", k,
                              as_device=True)
    dev_s = np.asarray(dev_s)[:n]
    dev_i = np.asarray(dev_i)[:n]
    np.testing.assert_allclose(np.sort(dev_s, axis=1),
                               np.sort(host_s, axis=1), atol=1e-6)
    assert ((dev_i >= 0) == (host_i >= 0)).all()


def test_knn_banded_as_device_rt_filter():
    rng = np.random.default_rng(4)
    n, d = 300, 64
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    mzs = np.sort(rng.uniform(500, 510, n))  # one wide band
    rts = rng.uniform(0, 100, n)
    k = 6
    host_s, host_i = knn_banded(vectors, mzs, 20.0, "ppm", k,
                                rts=rts, rt_tol=5.0)
    dev_s, dev_i = knn_banded(vectors, mzs, 20.0, "ppm", k,
                              rts=rts, rt_tol=5.0, as_device=True)
    dev_i = np.asarray(dev_i)[:n]
    assert ((dev_i >= 0) == (host_i >= 0)).all()
    np.testing.assert_allclose(
        np.sort(np.asarray(dev_s)[:n], axis=1),
        np.sort(host_s, axis=1), atol=1e-6,
    )


def test_device_block_cap_equivalence(processed_rows, tmp_path,
                                      monkeypatch):
    """With a small FALCON_TPU_DEVICE_BLOCK_CAP the engine splits a
    charge into precursor-m/z device blocks; on gap-separated data the
    splits align with gaps and labels match the single-block run."""
    from falcon_tpu.cluster import ann_engine
    from falcon_tpu.store.store import SpectrumStore

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    common = dict(
        eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm",
        rt_tol=None, fragment_tol=0.05, batch_size=2**15,
    )
    labels_1, med_1 = ann_engine.generate_clusters(ds, **common)
    monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "64")
    labels_b, med_b = ann_engine.generate_clusters(ds, **common)
    # Same partition (labels may renumber across blocks).
    from falcon_tpu import metrics

    assert metrics.cluster_purity(labels_b, labels_1) == 1.0
    assert metrics.cluster_completeness(labels_b, labels_1) == 1.0
    assert sorted(med_1.tolist()) == sorted(med_b.tolist())


def test_cross_block_parallel_dispatch(processed_rows, tmp_path,
                                       monkeypatch):
    """Independent device blocks dispatch concurrently — round-robin
    over the mesh devices with --devices N, 2-deep pipeline on one
    device — with labels identical to the serial loop (round-2 verdict
    #3)."""
    from falcon_tpu.cluster import ann_engine
    from falcon_tpu.store.store import SpectrumStore

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    common = dict(
        eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm",
        rt_tol=None, fragment_tol=0.05, batch_size=2**15,
    )
    monkeypatch.setenv("FALCON_TPU_DEVICE_BLOCK_CAP", "64")
    # Serial reference: pipeline depth 1.
    monkeypatch.setenv("FALCON_TPU_BLOCK_PIPELINE", "1")
    ann_engine._block_gauge["max"] = 0
    labels_serial, med_serial = ann_engine.generate_clusters(ds, **common)
    assert ann_engine._block_gauge["max"] <= 1

    # Multi-device: blocks round-robin over the 8 virtual devices.
    ann_engine._block_gauge["max"] = 0
    labels_mesh, med_mesh = ann_engine.generate_clusters(
        ds, devices=8, **common
    )
    assert ann_engine._block_gauge["max"] >= 2, (
        "expected >= 2 blocks resident concurrently"
    )
    np.testing.assert_array_equal(labels_serial, labels_mesh)
    np.testing.assert_array_equal(med_serial, med_mesh)

    # Single-device pipeline overlap (default depth 2): same labels.
    monkeypatch.delenv("FALCON_TPU_BLOCK_PIPELINE")
    ann_engine._block_gauge["max"] = 0
    labels_pipe, med_pipe = ann_engine.generate_clusters(ds, **common)
    assert ann_engine._block_gauge["max"] >= 2
    np.testing.assert_array_equal(labels_serial, labels_pipe)
    np.testing.assert_array_equal(med_serial, med_pipe)


def test_rt_holes_do_not_drop_prefilter_survivors(tmp_path):
    """--rt_tol punches holes into the bound-sorted candidate lists
    (``ops/knn._mask_invalid`` masks in place AFTER the top-k sort), so
    the prefilter compaction must size the kept width from the last
    surviving POSITION, not the survivor count.

    Regression: q's only true neighbor (s1) sits behind 20 RT-violating
    higher-bound candidates; a count-based width (1 -> 16 columns) cut
    the list at column 16 and silently dropped the position-20 survivor
    before the exact rerank, splitting {q, s1}."""
    rng = np.random.default_rng(0)
    common_mz = np.sort(
        rng.uniform(300.0, 1200.0, 20)
    ).astype(np.float32)

    def mk(c, unique_lo, rt, ident):
        # sqrt(c) of the L2 norm on the shared 20-peak set, the rest on
        # two unique peaks -> exact matched cosine vs q ~= sqrt(c).
        mz = np.concatenate([
            common_mz, np.float32([unique_lo, unique_lo + 7.0])
        ])
        inten = np.concatenate([
            np.full(20, np.sqrt(c / 20), np.float32),
            np.full(2, np.sqrt((1 - c) / 2), np.float32),
        ])
        order = np.argsort(mz)
        return dict(identifier=ident, precursor_mz=500.0,
                    precursor_charge=2, retention_time=float(rt),
                    mz=mz[order], intensity=inten[order],
                    filename="synthetic.mgf")

    rows = [mk(0.999, 130.0, 0.0, "q"), mk(0.78, 140.0, 5.0, "s1")]
    # 20 decoys: high bound vs q (~sqrt(.8*.999)=0.894 > thr=0.869) but
    # RT-violating; mutually below thr (0.80 < 0.869).
    for i in range(20):
        rows.append(mk(0.80, 160.0 + 9.0 * i, 5000.0, f"decoy{i}"))

    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    labels, _ = ann_engine.generate_clusters(
        store.dataset(2), eps=0.13, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=10.0,
        fragment_tol=0.05, batch_size=2**15, low_dim=1600,
        n_neighbors=64, min_mz=101.0, max_mz=1500.0, max_peaks=50,
    )
    # q and s1 (sim ~0.883, dist 0.117 < eps, RT gap 5 <= 10) must land
    # in the same cluster; no decoy may join them (RT gap 5000).
    assert labels[0] == labels[1]
    assert not (labels[2:] == labels[0]).any()


def test_band_bounds_cover_f32_kernel_acceptance():
    """The band window must contain every pair the device kernel's
    FLOAT32 tolerance comparison accepts, for both modes — otherwise
    neighbor sets depend on block geometry (review finding r3)."""
    from falcon_tpu.ops.knn import band_bounds

    rng = np.random.default_rng(77)
    # Dense cluster of near-identical masses maximizes boundary pairs.
    base = np.sort(rng.uniform(300.0, 1500.0, 300))
    mzs = np.sort(np.concatenate(
        [base, base * (1 + rng.uniform(-25e-6, 25e-6, len(base)))]
    ))
    mzs32 = mzs.astype(np.float32)
    for tol_mass, tol_is_da in ((20.0, False), (0.01, True)):
        band_lo, band_hi = band_bounds(mzs, tol_mass, tol_is_da)
        q = mzs32[:, None].astype(np.float32)
        c = mzs32[None, :].astype(np.float32)
        if tol_is_da:
            accepted = np.abs(
                (q - c).astype(np.float32)) <= np.float32(tol_mass)
        else:
            diff = np.abs((q - c).astype(np.float32))
            accepted = (diff / c * np.float32(1e6)) <= np.float32(
                tol_mass)
        ii, jj = np.nonzero(accepted)
        inside = (jj >= band_lo[ii]) & (jj < band_hi[ii])
        assert inside.all(), (
            f"{(~inside).sum()} f32-accepted pairs outside the band "
            f"window (tol_is_da={tol_is_da})"
        )


@pytest.mark.parametrize("linkage", ["complete", "average", "single"])
def test_ann_linkage_matches_exact_engine(processed_rows, tmp_path,
                                          linkage):
    """cluster_method='linkage' (the default) reproduces the EXACT
    backend's labels AND medoids: eps-components from the ANN graph,
    then the reference's hierarchical clustering on exact distances
    inside each component (round-3 verdict #1/#4)."""
    from falcon_tpu import metrics
    from falcon_tpu.cluster import engine

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    labels_ann, med_ann = ann_engine.generate_clusters(
        ds, eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15,
        cluster_method="linkage", linkage=linkage,
    )
    labels_ex, med_ex = engine.generate_clusters(
        ds, linkage, 0.1, 0, 20.0, "ppm", None, 0.05, 2**15,
    )
    agree = metrics.pairwise_agreement(labels_ann, labels_ex)
    assert agree["f1"] == 1.0, agree
    assert sorted(med_ann.tolist()) == sorted(med_ex.tolist())


def test_ann_linkage_rt_tol_matches_exact_engine(processed_rows,
                                                 tmp_path):
    """The mz/RT refinement inside linkage mode matches the exact
    engine when --rt_tol is set."""
    from falcon_tpu import metrics
    from falcon_tpu.cluster import engine

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    labels_ann, med_ann = ann_engine.generate_clusters(
        ds, eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=60.0,
        fragment_tol=0.05, batch_size=2**15,
        cluster_method="linkage", linkage="complete",
    )
    labels_ex, med_ex = engine.generate_clusters(
        ds, "complete", 0.1, 0, 20.0, "ppm", 60.0, 0.05, 2**15,
    )
    agree = metrics.pairwise_agreement(labels_ann, labels_ex)
    assert agree["f1"] == 1.0, agree
    assert sorted(med_ann.tolist()) == sorted(med_ex.tolist())


def test_dbscan_medoids_match_exact_distances(processed_rows, tmp_path):
    """DBSCAN-mode medoids come from the reranked EXACT distances:
    every cluster's medoid equals the brute-force min-row-sum of exact
    peak-matching distances over its members (clusters here are smaller
    than k_final, so every within-cluster pair is listed)."""
    from falcon_tpu.cluster.oracle import cosine_exact

    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    labels, medoids = ann_engine.generate_clusters(
        ds, eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=20.0, precursor_tol_mode="ppm", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15, cluster_method="dbscan",
    )
    mz, intensity, lengths = _padded(rows)

    def exact_dist(i, j):
        s, _ = cosine_exact(
            mz[i][: lengths[i]], intensity[i][: lengths[i]],
            mz[j][: lengths[j]], intensity[j][: lengths[j]], 0.05,
        )
        return 1.0 - s

    med_set = set(medoids.tolist())
    n_multi = 0
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab)
        if len(members) < 2:
            assert members[0] in med_set
            continue
        n_multi += 1
        sums = np.array([
            sum(exact_dist(i, j) for j in members if j != i)
            for i in members
        ])
        # Allow ties within f32 kernel tolerance.
        best = sums <= sums.min() + 1e-4
        assert any(members[k] in med_set for k in np.flatnonzero(best)), (
            lab, members, sums,
        )
    assert n_multi >= 10  # the fixture must actually exercise clusters


def test_dense_band_adaptive_neighbor_budget(tmp_path, caplog):
    """A precursor band wider than n_neighbors_ann widens the retrieval
    width (power-of-two steps, logged); a band wider than even
    FALCON_TPU_MAX_NEIGHBORS warns with the affected row fraction
    (round-3 verdict #6)."""
    import logging

    from falcon_tpu import metrics
    from falcon_tpu.cluster import engine

    # One dense band: every spectrum within precursor tolerance.
    spectra, _ = make_clustered_spectra(
        n_clusters=6, cluster_size=8, n_noise=10, seed=11, charges=(2,),
        precursor_classes=1,
    )
    rows = [
        p for s in spectra
        if (p := process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01,
                                  50, None)) is not None
    ]
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    common = dict(
        eps=0.1, min_samples=2, min_matches=0,
        precursor_tol_mass=0.5, precursor_tol_mode="Da", rt_tol=None,
        fragment_tol=0.05, batch_size=2**15,
    )
    with caplog.at_level(logging.INFO, logger="falcon_tpu"):
        labels, _ = ann_engine.generate_clusters(
            ds, n_neighbors=8, n_neighbors_ann=4, **common
        )
    assert any("widening the retrieval width" in r.message
               for r in caplog.records)
    # With the widened width the dense band clusters exactly like the
    # exact backend.
    labels_ex, _ = engine.generate_clusters(
        ds, "complete", 0.1, 0, 0.5, "Da", None, 0.05, 2**15,
    )
    assert metrics.pairwise_agreement(labels, labels_ex)["f1"] == 1.0

    # Band wider than the budget itself -> explicit truncation warning.
    caplog.clear()
    import os as _os

    _os.environ["FALCON_TPU_MAX_NEIGHBORS"] = "4"
    try:
        with caplog.at_level(logging.WARNING, logger="falcon_tpu"):
            ann_engine.generate_clusters(ds, n_neighbors=4,
                                         n_neighbors_ann=4, **common)
    finally:
        del _os.environ["FALCON_TPU_MAX_NEIGHBORS"]
    assert any("than the neighbor budget" in r.message
               for r in caplog.records)


def test_knn_banded_column_streaming_parity(monkeypatch):
    """Column-streamed banded scan (running top-k over window chunks)
    returns exactly the single-window results — the wideband regime now
    runs the same exact scan with bounded HBM (round-3 verdict #2)."""
    rng = np.random.default_rng(8)
    n, d = 1500, 128
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    # One wide band: every row within tolerance of every other.
    mzs = np.sort(rng.uniform(700.0, 700.005, n))
    k = 16
    s_ref, i_ref = knn_banded(vectors, mzs, 20.0, "ppm", k,
                              exact_topk=True)
    monkeypatch.setenv("FALCON_TPU_KNN_COL_CHUNK", "512")
    s_str, i_str = knn_banded(vectors, mzs, 20.0, "ppm", k,
                              exact_topk=True)
    np.testing.assert_allclose(np.sort(s_str, axis=1),
                               np.sort(s_ref, axis=1), atol=1e-6)
    assert ((i_str >= 0) == (i_ref >= 0)).all()
    # Asymmetric (prefilter-style) queries stream identically.
    q = rng.normal(size=(n, d)).astype(np.float32)
    s_ref2, _ = knn_banded(vectors, mzs, 20.0, "ppm", k,
                           exact_topk=True, q_vectors=q)
    monkeypatch.delenv("FALCON_TPU_KNN_COL_CHUNK")
    monkeypatch.setenv("FALCON_TPU_KNN_COL_CHUNK", "256")
    s_str2, _ = knn_banded(vectors, mzs, 20.0, "ppm", k,
                           exact_topk=True, q_vectors=q)
    np.testing.assert_allclose(np.sort(s_str2, axis=1),
                               np.sort(s_ref2, axis=1), atol=1e-5)


def test_knn_banded_dispatch_capping_parity(monkeypatch):
    """Splitting the banded scan into several bounded dispatches
    (FLOP-capped row-block groups) returns exactly the single-dispatch
    results — the guard against minutes-long single programs that get
    the pooled worker killed."""
    rng = np.random.default_rng(12)
    n, d = 3000, 64
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    mzs = np.sort(rng.uniform(400.0, 1200.0, n))
    k = 8
    s_ref, i_ref = knn_banded(vectors, mzs, 20.0, "ppm", k,
                              exact_topk=True)
    # Cap so low every dispatch holds one row block.
    monkeypatch.setenv("FALCON_TPU_KNN_DISPATCH_PFLOPS", "1e-9")
    s_split, i_split = knn_banded(vectors, mzs, 20.0, "ppm", k,
                                  exact_topk=True)
    np.testing.assert_array_equal(i_split, i_ref)
    np.testing.assert_allclose(s_split, s_ref, atol=0)


def test_linkage_component_batch_size_cap(tmp_path, caplog):
    """An eps-component larger than batch_size is chunked for linkage
    (the reference's own oversized-interval semantics) instead of
    materializing an unbounded condensed matrix (round-4 review)."""
    import logging

    rows = []
    spectra, _ = make_clustered_spectra(
        n_clusters=4, cluster_size=16, n_noise=0, seed=13, charges=(2,),
        precursor_classes=1,
    )
    for s in spectra:
        p = process_spectrum(s, 5, 250, 101.0, 1500.0, 1.5, 0.01, 50,
                             None)
        if p is not None:
            rows.append(p)
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    # Loose eps keeps each 16-member template together; batch_size=8
    # forces chunking.
    with caplog.at_level(logging.WARNING, logger="falcon_tpu"):
        labels, medoids = ann_engine.generate_clusters(
            ds, eps=0.9, min_samples=2, min_matches=0,
            precursor_tol_mass=0.5, precursor_tol_mode="Da", rt_tol=None,
            fragment_tol=0.05, batch_size=8,
        )
    assert any("chunked for linkage" in r.message for r in caplog.records)
    assert (labels >= 0).all()
    assert len(medoids) == len(np.unique(labels))


def test_exact_banded_topk_column_streamed(processed_rows, monkeypatch):
    """Forced multi-pass column streaming + small row blocks return the
    same exact top-k as the single-pass panel (round-4 verdict item 5:
    the oracle path must run at ANY band width in bounded memory)."""
    from falcon_tpu.ops.exact_knn import exact_banded_topk
    from falcon_tpu.ops.pairwise import PAD_MZ

    rows, _ = processed_rows
    mz, intensity, _ = _padded(rows)
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    mz, intensity, pmz = mz[order], intensity[order], pmz[order]
    n = len(pmz)
    n_pad = 512
    while n_pad < n:
        n_pad *= 2
    mz_pad = np.full((n_pad, mz.shape[1]), PAD_MZ, np.float32)
    int_pad = np.zeros((n_pad, mz.shape[1]), np.float32)
    mz_pad[:n], int_pad[:n] = mz, intensity
    k = 8
    # Wide tolerance so the window spans several forced sub-windows.
    common = (jnp.asarray(mz_pad), jnp.asarray(int_pad), pmz, 500.0,
              "Da", k, 0.05)
    sims_ref, neigh_ref = exact_banded_topk(*common, min_matches=4)
    monkeypatch.setenv("FALCON_TPU_EXACT_COL_CHUNK", "128")
    monkeypatch.setenv("FALCON_TPU_EXACT_BLOCK_ROWS", "128")
    sims_mp, neigh_mp = exact_banded_topk(*common, min_matches=4)
    sims_ref, sims_mp = np.asarray(sims_ref)[:n], np.asarray(sims_mp)[:n]
    neigh_ref = np.asarray(neigh_ref)[:n]
    neigh_mp = np.asarray(neigh_mp)[:n]
    np.testing.assert_allclose(sims_mp, sims_ref, atol=1e-5)
    # Neighbor sets match wherever scores are distinct (ties may permute).
    same = sims_ref > -1.0
    assert (np.sort(neigh_ref, axis=1)[same.any(axis=1)].shape
            == np.sort(neigh_mp, axis=1)[same.any(axis=1)].shape)
    agree = (np.sort(np.where(same, neigh_ref, -1), axis=1)
             == np.sort(np.where(same, neigh_mp, -1), axis=1))
    assert agree.mean() > 0.99


def test_knn_banded_bf16_certified_margin(processed_rows):
    """bf16 upper-bound scan: every candidate the f32 scan finds is
    present with a score >= f32 * (1 - 0.01) (the certified margin in
    ops/knn._banded_topk), so thresholding at thr * 0.99 never drops a
    candidate whose true bound reaches thr."""
    rows, _ = processed_rows
    hasher = SpectrumHasher(101.0, 1500.0, 0.05, low_dim=400, seed=0)
    mz, intensity, _ = _padded(rows)
    plain = np.asarray(hasher.vectorize(
        jnp.asarray(mz), jnp.asarray(intensity), norm=False))
    spread = np.asarray(hasher.vectorize(
        jnp.asarray(mz), jnp.asarray(intensity), norm=False, spread=True))
    pmz = np.asarray([r["precursor_mz"] for r in rows])
    order = np.argsort(pmz, kind="stable")
    plain, spread, pmz = plain[order], spread[order], pmz[order]
    # k = 64 covers every in-band candidate for this fixture (bands are
    # tiny), so top-k truncation cannot confound the set comparison.
    k = 64
    s32, n32 = knn_banded(plain, pmz, 20.0, "ppm", k, block_rows=64,
                          exact_topk=True, q_vectors=spread)
    s16, n16 = knn_banded(plain, pmz, 20.0, "ppm", k, block_rows=64,
                          exact_topk=True, q_vectors=spread,
                          scan_bf16=True)
    n = len(pmz)
    for i in range(n):
        f32_set = {int(j): float(s) for j, s in zip(n32[i], s32[i])
                   if j >= 0}
        bf16_set = {int(j): float(s) for j, s in zip(n16[i], s16[i])
                    if j >= 0}
        assert set(f32_set) == set(bf16_set)
        for j, s_f32 in f32_set.items():
            assert bf16_set[j] >= s_f32 * (1.0 - 0.01) - 1e-6


def test_engine_bf16_scan_matches_f32_labels(processed_rows, tmp_path,
                                             monkeypatch):
    """End-to-end labels are identical under the default bf16 prefilter
    scan and the FALCON_TPU_KNN_DTYPE=f32 fallback, in both cluster
    methods (the exact rerank re-scores every survivor in f32)."""
    rows, _ = processed_rows
    store = SpectrumStore(str(tmp_path / "spectra"))
    w = store.writer()
    w.add_many(rows)
    w.close()
    store.save_charges([2])
    ds = store.dataset(2)
    for method in ("dbscan", "linkage"):
        out = {}
        for dtype in ("bf16", "f32"):
            monkeypatch.setenv("FALCON_TPU_KNN_DTYPE", dtype)
            out[dtype], _ = ann_engine.generate_clusters(
                ds, eps=0.1, min_samples=2, min_matches=0,
                precursor_tol_mass=20.0, precursor_tol_mode="ppm",
                rt_tol=None, fragment_tol=0.05, batch_size=2**15,
                cluster_method=method,
            )
        np.testing.assert_array_equal(out["bf16"], out["f32"])
