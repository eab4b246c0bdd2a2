from falcon_tpu.utils.natsort import natsorted, natsort_key


def test_natsort_numeric_order():
    values = ["scan10", "scan2", "scan1", "scan2b", "scan2a"]
    assert natsorted(values) == [
        "scan1", "scan2", "scan2a", "scan2b", "scan10"
    ]


def test_natsort_mixed_text():
    assert natsorted(["b1", "a10", "a2"]) == ["a2", "a10", "b1"]


def test_natsort_key_tuple_pairs():
    values = [("f2.mgf", "scan10"), ("f2.mgf", "scan9"), ("f10.mgf", "s1")]
    ordered = sorted(values, key=lambda t: tuple(map(natsort_key, t)))
    assert ordered == [
        ("f2.mgf", "scan9"), ("f2.mgf", "scan10"), ("f10.mgf", "s1")
    ]


def test_native_natsort_pairs_matches_python():
    import numpy as np
    import pytest

    from falcon_tpu import native
    from falcon_tpu.utils.natsort import natsort_key

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    primary = [
        "b.mgf", "a10.mgf", "a2.mgf", "a2.mgf", "a02.mgf", "a.mgf",
        "file_007", "file_7", "file_07x", "z", "",
    ]
    secondary = [
        "scan10", "scan2", "scan10", "scan2", "scan3", "x1y", "x1z",
        "x01y", "s", "s", "t",
    ]
    got = native.natsort_pairs(primary, secondary)
    want = sorted(
        range(len(primary)),
        key=lambda i: (natsort_key(primary[i]),
                       natsort_key(secondary[i])),
    )
    assert list(got) == want


def test_native_natsort_pairs_random_parity():
    import random

    import pytest

    from falcon_tpu import native
    from falcon_tpu.utils.natsort import natsort_key

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = random.Random(0)
    alphabet = "abc019_."
    strings = [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 12)))
        for _ in range(500)
    ]
    primary = [rng.choice(strings) for _ in range(500)]
    secondary = [rng.choice(strings) for _ in range(500)]
    got = native.natsort_pairs(primary, secondary)
    want = sorted(
        range(500),
        key=lambda i: (natsort_key(primary[i]),
                       natsort_key(secondary[i])),
    )
    assert list(got) == want
    # The zero-copy UTF-32 path (numpy U arrays hit
    # fc_natsort_pairs_u32, a separate comparator) must order
    # identically — including non-ASCII, whose UTF-32 code-point order
    # must match the object path's UTF-8 byte order.
    import numpy as np

    unicode_extra = ["ü2", "ü10", "é1", "\U0001F600x", "z9"]
    prim_u = np.asarray(primary[:-len(unicode_extra)] + unicode_extra)
    sec_u = np.asarray(secondary)
    got_u32 = native.natsort_pairs(prim_u, sec_u)
    want_u32 = sorted(
        range(500),
        key=lambda i: (natsort_key(str(prim_u[i])),
                       natsort_key(str(sec_u[i]))),
    )
    assert list(got_u32) == want_u32


def test_upload_padded_peaks_matches_host_padding():
    import numpy as np

    from falcon_tpu.ops.xfer import upload_padded_peaks
    from falcon_tpu.store.store import padded_peaks

    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 20, 37)
    lengths[3] = 0  # zero-length rows must not shift later rows
    lengths[4] = 0
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    mz_flat = rng.uniform(100, 1500, offsets[-1]).astype(np.float32)
    int_flat = rng.random(offsets[-1]).astype(np.float32)
    order = rng.permutation(len(lengths))
    pad_to, n_rows = 24, 64
    want_mz, want_int, _ = padded_peaks(offsets, mz_flat, int_flat,
                                        pad_to, order)
    got_mz, got_int = upload_padded_peaks(offsets, mz_flat, int_flat,
                                          order, pad_to, n_rows)
    got_mz = np.asarray(got_mz)
    got_int = np.asarray(got_int)
    np.testing.assert_array_equal(got_mz[: len(order)], want_mz)
    np.testing.assert_array_equal(got_int[: len(order)], want_int)
    # Rows past the selection are pure padding.
    assert (got_mz[len(order):] == -1e6).all()
    assert (got_int[len(order):] == 0).all()
