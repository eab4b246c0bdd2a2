"""ctypes bindings for the first-party native host library.

``native/falcon_native.cc`` provides the sequential host-side algorithms
that have no efficient data-parallel device mapping (SURVEY.md §2.3):
nearest-neighbor-chain agglomerative linkage (replacing fastcluster),
distance-threshold tree cuts
(replacing ``scipy.cluster.hierarchy.fcluster``), and union-find connected
components for density clustering.

The shared library is built from the sources in the tree with
``make -C native`` on first use (and again whenever a source is newer than
it), so ``-march=native`` always targets the host that runs it; if the
toolchain is unavailable, a SciPy fallback keeps the pipeline functional
(used only as a fallback — the native path is the product).
"""

import ctypes
import fcntl
import glob
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("falcon_tpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfalcon_native.so")

_METHODS = {"single": 0, "complete": 1, "average": 2}

_lib = None
_lib_lock = threading.Lock()


def _stale() -> bool:
    """True when the library is missing or older than a source file."""
    if not os.path.isfile(_LIB_PATH):
        return True
    sources = glob.glob(os.path.join(_NATIVE_DIR, "*.cc")) + glob.glob(
        os.path.join(_NATIVE_DIR, "*.h")) + [
            os.path.join(_NATIVE_DIR, "Makefile")]
    newest = max(os.path.getmtime(f) for f in sources if os.path.isfile(f))
    return os.path.getmtime(_LIB_PATH) < newest


def _build() -> bool:
    """Build the library if stale.  Concurrent processes (test workers,
    ingest pools) serialize on a file lock, and the library is compiled
    under a private name and renamed into place, so no process ever
    loads a half-written file."""
    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale():
                return True
            tmp = f".libfalcon_native.{os.getpid()}.so"
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                    check=True, capture_output=True,
                )
                os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
            finally:
                if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                    os.remove(os.path.join(_NATIVE_DIR, tmp))
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning("Could not build native library: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        if _stale() and not _build():
            _lib = False
            return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fc_linkage.restype = ctypes.c_int
        lib.fc_linkage.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ]
        lib.fc_fcluster.restype = ctypes.c_int64
        lib.fc_fcluster.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fc_connected_components.restype = ctypes.c_int64
        lib.fc_connected_components.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fc_mgf_ingest.restype = ctypes.c_void_p
        lib.fc_mgf_ingest.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        if hasattr(lib, "fc_mgf_ingest_range"):
            lib.fc_mgf_ingest_range.restype = ctypes.c_void_p
            lib.fc_mgf_ingest_range.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
            ]
        lib.fc_mgf_result_copy.restype = ctypes.c_int
        lib.fc_mgf_result_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char),
        ]
        lib.fc_mgf_result_free.restype = None
        lib.fc_mgf_result_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "fc_result_n_unsupported"):
            lib.fc_result_n_unsupported.restype = ctypes.c_int64
            lib.fc_result_n_unsupported.argtypes = [ctypes.c_void_p]
        for entry in ("fc_mzml_ingest", "fc_mzxml_ingest",
                      "fc_msp_ingest"):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_void_p
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                ]
        for entry in ("fc_mzml_ingest_range", "fc_mzxml_ingest_range",
                      "fc_msp_ingest_range"):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_void_p
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                ]
        lib.fc_natsort_pairs.restype = ctypes.c_int
        lib.fc_natsort_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        if hasattr(lib, "fc_natsort_pairs_u32"):
            lib.fc_natsort_pairs_u32.restype = ctypes.c_int
            lib.fc_natsort_pairs_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int,
            ]
        if hasattr(lib, "fc_csv_format_rows_u32"):
            lib.fc_csv_format_rows_u32.restype = ctypes.c_int64
            lib.fc_csv_format_rows_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                ctypes.c_int,
            ]
            lib.fc_buffer_free.restype = None
            lib.fc_buffer_free.argtypes = [
                ctypes.POINTER(ctypes.c_char)]
        _lib = lib
        return lib


def _as_double_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _n_from_condensed(m: int) -> int:
    n = int(round((1 + np.sqrt(1 + 8 * m)) / 2))
    if n * (n - 1) // 2 != m:
        raise ValueError(f"invalid condensed matrix length {m}")
    return n


def linkage(condensed: np.ndarray, method: str) -> np.ndarray:
    """Agglomerative linkage on a condensed distance matrix.

    Returns the (n-1, 4) scipy-format linkage (rows sorted by distance).
    Reference behavior: ``fastcluster.linkage(pdist, linkage)``
    (``falcon/cluster/cluster.py:285``).
    """
    if method not in _METHODS:
        raise ValueError(f"unsupported linkage method {method!r}")
    n = _n_from_condensed(len(condensed))
    lib = get_lib()
    if lib is None:
        import scipy.cluster.hierarchy as sch

        return sch.linkage(condensed, method)
    # Exactly one copy: fc_linkage destroys its input, so aliasing the
    # caller's array is unsafe, but ascontiguousarray(...).copy() paid a
    # second ~2.1 GB copy at the interval cap whenever a dtype
    # conversion already copied.
    work = np.array(condensed, np.float64, order="C", copy=True)
    z = np.empty((n - 1, 4), np.float64)
    rc = lib.fc_linkage(
        _as_double_ptr(work), ctypes.c_int64(n),
        ctypes.c_int(_METHODS[method]), _as_double_ptr(z),
    )
    if rc == 2:
        # Same contract as scipy: a non-finite distance has no defined
        # merge order (and would corrupt the NN-chain walk in C++).
        raise ValueError(
            "linkage requires a finite condensed distance matrix "
            "(found NaN or infinity)")
    if rc != 0:
        raise RuntimeError(f"fc_linkage failed with code {rc}")
    return z


def fcluster(z: np.ndarray, t: float, n: Optional[int] = None) -> np.ndarray:
    """Flat clusters from a linkage via a distance-threshold cut.

    0-based labels grouped exactly as scipy's
    ``fcluster(Z, t, "distance")`` for monotone linkages (reference call
    sites ``falcon/cluster/cluster.py:283-290, 413-421``; the reference
    subtracts 1 from scipy's 1-based labels).
    """
    if n is None:
        n = z.shape[0] + 1
    lib = get_lib()
    if lib is None:
        import scipy.cluster.hierarchy as sch

        return (sch.fcluster(z, t, "distance") - 1).astype(np.int32)
    z = np.ascontiguousarray(z, np.float64)
    labels = np.empty(n, np.int32)
    k = lib.fc_fcluster(
        _as_double_ptr(z), ctypes.c_int64(n), ctypes.c_double(t),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if k < 0:
        raise ValueError(
            "fcluster got an invalid linkage matrix (non-finite or "
            "out-of-range cluster ids)")
    return labels


_NULL_CHARGE_I32 = -(2**31)  # C++ kNullCharge sentinel
_SCALING_CODES = {None: 0, "off": 0, "root": 1, "log": 2, "rank": 3}


def mgf_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> Optional[dict]:
    """Parse + preprocess an entire MGF file in the native library.

    ``start``/``end`` select a byte range: the call parses exactly the
    spectra whose BEGIN IONS line starts in ``[start, end)``, so
    arbitrary byte splits concatenate to the whole-file parse (the
    parallel single-file ingest path, ``ingest.py``).  The C call
    releases the GIL, so ranges of one file parse concurrently from a
    thread pool.  Every call (ranged or not) re-reads the file head for
    MGF header params (merged into each spectrum, local keys winning);
    the header scan is capped at 1 MB (SURVEY.md §3.5).

    Returns a columnar batch (same preprocessing semantics as
    ``preprocess.process_spectrum`` over ``ms_io.get_spectra``; parity
    enforced by tests/test_native_ingest.py)::

        {"identifier": unicode (n,), "precursor_mz": f64 (n,),
         "precursor_charge": i32 (n,) with _NULL_CHARGE_I32 for None,
         "retention_time": f64 (n,), "peak_offsets": i64 (n+1,),
         "mz": f32 flat, "intensity": f32 flat,
         "n_read": int, "n_low_quality": int}

    or None when the native library (or the file) is unavailable — the
    caller falls back to the Python path.
    """
    return _native_ingest(filename, "fc_mgf_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end)


def mzml_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> Optional[dict]:
    """Parse + preprocess an entire mzML file in the native library
    (``native/falcon_mzml.cc``); same batch contract as
    :func:`mgf_ingest`.  A truncated document additionally sets
    ``batch["truncated"] = True`` so the caller can warn like the
    Python reader does.  ``start``/``end`` select a byte range (block
    ownership by ``<spectrum`` open-tag offset, so arbitrary splits
    concatenate to the whole-file parse; the GIL is released during
    the C call)."""
    return _native_ingest(filename, "fc_mzml_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end)


def mzxml_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> Optional[dict]:
    """Parse + preprocess an entire mzXML file in the native library
    (``native/falcon_mzml.cc``); same batch contract as
    :func:`mgf_ingest` (+ ``truncated`` flag and ``start``/``end``
    byte-range selection, as for mzML — ownership by each ``<scan``
    open tag's own offset, nested MS2 scans included)."""
    return _native_ingest(filename, "fc_mzxml_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end)


def msp_ingest(
    filename: str,
    min_peaks: int,
    min_mz_range: float,
    mz_min: Optional[float] = None,
    mz_max: Optional[float] = None,
    remove_precursor_tolerance: Optional[float] = None,
    min_intensity: Optional[float] = None,
    max_peaks_used: Optional[int] = None,
    scaling: Optional[str] = None,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> Optional[dict]:
    """Parse + preprocess an entire MSP spectral library in the native
    library (``native/falcon_ingest.cc``, mirroring
    ``ms_io/msp_io.py``); same batch contract as :func:`mgf_ingest`,
    including ``start``/``end`` byte-range selection (ownership by each
    ``Name:`` line's offset, so arbitrary splits concatenate to the
    whole-file parse)."""
    return _native_ingest(filename, "fc_msp_ingest", min_peaks,
                          min_mz_range, mz_min, mz_max,
                          remove_precursor_tolerance, min_intensity,
                          max_peaks_used, scaling, start=start, end=end)


def _native_ingest(filename, entry, min_peaks, min_mz_range, mz_min,
                   mz_max, remove_precursor_tolerance, min_intensity,
                   max_peaks_used, scaling, start=None,
                   end=None) -> Optional[dict]:
    lib = get_lib()
    if lib is None or not hasattr(lib, entry):
        return None
    is_xml = entry in ("fc_mzml_ingest", "fc_mzxml_ingest")
    range_args = ()
    if start is not None or end is not None:
        range_entry = entry + "_range"
        if not hasattr(lib, range_entry):
            return None  # stale library build — caller falls back
        entry = range_entry
        range_args = (ctypes.c_int64(start or 0),
                      ctypes.c_int64(-1 if end is None else end))
    counts = (ctypes.c_int64 * 7)()
    nan = float("nan")
    handle = getattr(lib, entry)(
        os.fsencode(filename),
        *range_args,
        ctypes.c_int(min_peaks),
        ctypes.c_double(min_mz_range),
        ctypes.c_double(nan if mz_min is None else mz_min),
        ctypes.c_double(nan if mz_max is None else mz_max),
        ctypes.c_double(
            nan if remove_precursor_tolerance is None
            else remove_precursor_tolerance
        ),
        ctypes.c_double(nan if min_intensity is None else min_intensity),
        ctypes.c_int(0 if max_peaks_used is None else max_peaks_used),
        ctypes.c_int(_SCALING_CODES[scaling]),
        counts,
    )
    if not handle:
        return None
    try:
        n, n_peaks, title_bytes, n_read, n_low_quality = (
            int(counts[i]) for i in range(5)
        )
        truncated = bool(counts[5]) if is_xml else False
        n_blocks = int(counts[6])
        n_unsupported = (
            int(lib.fc_result_n_unsupported(handle))
            if hasattr(lib, "fc_result_n_unsupported") else 0
        )
        precursor_mz = np.empty(n, np.float64)
        charge = np.empty(n, np.int32)
        rt = np.empty(n, np.float64)
        peak_offsets = np.empty(n + 1, np.int64)
        mz = np.empty(n_peaks, np.float32)
        intensity = np.empty(n_peaks, np.float32)
        title_offsets = np.empty(n + 1, np.int64)
        titles = ctypes.create_string_buffer(max(title_bytes, 1))
        rc = lib.fc_mgf_result_copy(
            handle,
            _as_double_ptr(precursor_mz),
            charge.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _as_double_ptr(rt),
            peak_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            mz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            title_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            titles,
        )
        if rc != 0:
            raise RuntimeError("fc_mgf_result_copy failed")
    finally:
        lib.fc_mgf_result_free(handle)
    raw = titles.raw[:title_bytes]
    identifiers = np.array(
        [
            raw[title_offsets[i]:title_offsets[i + 1]].decode(
                "utf-8", "replace"
            )
            for i in range(n)
        ],
        dtype=object if n == 0 else None,
    )
    if n == 0:
        identifiers = np.empty(0, dtype="U1")
    return {
        "identifier": identifiers,
        "precursor_mz": precursor_mz,
        "precursor_charge": charge,
        "retention_time": rt,
        "peak_offsets": peak_offsets,
        "mz": mz,
        "intensity": intensity,
        "n_read": n_read,
        "n_low_quality": n_low_quality,
        "truncated": truncated,
        "n_blocks": n_blocks,
        # Spectra skipped for unsupported binary compression (numpress
        # etc.); ingest warns so a fully-numpress file is not silently
        # dropped.  0 with a stale library build (symbol absent).
        "n_unsupported": n_unsupported,
    }


def _u32_col(col) -> Optional[Tuple[np.ndarray, int]]:
    """Numpy U-dtype column -> (contiguous array, width in UTF-32 code
    units) for zero-copy native access, or None if ``col`` is anything
    else (caller uses the per-object path).  Big-endian arrays (foreign
    npy files) are excluded — the native side reads native-endian."""
    if (not isinstance(col, np.ndarray) or col.dtype.kind != "U"
            or col.dtype.str[0] == ">"):
        return None
    arr = np.ascontiguousarray(col)
    return arr, arr.dtype.itemsize // 4


def _export_threads() -> int:
    """Worker threads for the export kernels (natsort + CSV format).
    Defaults to the host's core count (the 25M-export tail is the one
    single-threaded stretch left on a multicore host); capped at
    16 — the kernels saturate memory bandwidth well before that.
    FALCON_TPU_EXPORT_THREADS overrides."""
    try:
        t = int(os.environ.get("FALCON_TPU_EXPORT_THREADS",
                               os.cpu_count() or 1))
    except ValueError:
        t = 1
    return max(1, min(t, 16))


def natsort_pairs(primary, secondary) -> Optional[np.ndarray]:
    """Stable natural-order argsort of (primary, secondary) string pairs.

    Matches ``utils.natsort.natsort_key`` tuple semantics (digits compare
    numerically and before text at the same position; parity enforced by
    tests/test_utils.py).  Returns None when the native library is
    unavailable (caller falls back to the Python keys).

    Numpy U-dtype arrays take a zero-copy fast path (the raw fixed-width
    UTF-32 buffer goes straight to the native sort); at 25M export rows
    the per-string Python-object repacking this skips costs tens of
    seconds.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "fc_natsort_pairs"):
        return None
    n = len(primary)
    if hasattr(lib, "fc_natsort_pairs_u32"):
        fa, fb = _u32_col(primary), _u32_col(secondary)
        if fa is not None and fb is not None:
            (arr_a, w_a), (arr_b, w_b) = fa, fb
            order = np.empty(n, np.int64)
            rc = lib.fc_natsort_pairs_u32(
                arr_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int64(w_a),
                arr_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int64(w_b),
                ctypes.c_int64(n),
                order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.c_int(_export_threads()),
            )
            if rc != 0:
                raise RuntimeError("fc_natsort_pairs_u32 failed")
            return order

    def pack(strings):
        encoded = [s.encode("utf-8") for s in strings]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        return b"".join(encoded), offsets

    bytes_a, offs_a = pack(primary)
    bytes_b, offs_b = pack(secondary)
    order = np.empty(n, np.int64)
    rc = lib.fc_natsort_pairs(
        ctypes.cast(ctypes.c_char_p(bytes_a),
                    ctypes.POINTER(ctypes.c_char)),
        offs_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.cast(ctypes.c_char_p(bytes_b),
                    ctypes.POINTER(ctypes.c_char)),
        offs_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError("fc_natsort_pairs failed")
    return order


def csv_rows(filenames, identifiers, charges, null_charge, mzs, rts,
             clusters) -> Optional[bytes]:
    """Format cluster-assignment CSV rows natively, byte-for-byte like
    ``csv.writer(f, lineterminator="\\n")`` fed ``str()`` of the same
    values (parity enforced by tests/test_export.py, including Python
    float-repr semantics, QUOTE_MINIMAL quoting, and the empty
    null-charge field).  ``filenames``/``identifiers`` must be numpy
    string arrays.  Returns the encoded UTF-8 bytes, or None when the
    native path is unavailable (caller falls back to csv.writer)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "fc_csv_format_rows_u32"):
        return None
    n = len(clusters)
    if n == 0:
        return b""
    fn = _u32_col(np.asarray(filenames))
    sid = _u32_col(np.asarray(identifiers))
    if fn is None or sid is None:
        return None
    (fn_b, fn_w), (id_b, id_w) = fn, sid
    charges = np.ascontiguousarray(charges, np.int64)

    def float_col(col):
        # Preserve storage precision: str(np.float32) formats
        # differently from str(float) and the native side mirrors both.
        # Any OTHER dtype (float16, int...) would silently diverge from
        # the csv.writer fallback if widened -> decline the fast path.
        arr = np.asarray(col)
        if arr.dtype not in (np.float32, np.float64):
            return None, 0
        return np.ascontiguousarray(arr), int(arr.dtype == np.float32)

    mzs, mz_f32 = float_col(mzs)
    rts, rt_f32 = float_col(rts)
    if mzs is None or rts is None:
        return None
    clusters = np.ascontiguousarray(clusters, np.int64)
    buf_ptr = ctypes.POINTER(ctypes.c_char)()
    written = lib.fc_csv_format_rows_u32(
        fn_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(fn_w),
        id_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(id_w),
        charges.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(null_charge),
        ctypes.c_void_p(mzs.ctypes.data), ctypes.c_int(mz_f32),
        ctypes.c_void_p(rts.ctypes.data), ctypes.c_int(rt_f32),
        clusters.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
        ctypes.byref(buf_ptr),
        ctypes.c_int(_export_threads()),
    )
    if written < 0:
        return None
    try:
        return ctypes.string_at(buf_ptr, written)
    finally:
        lib.fc_buffer_free(buf_ptr)


def connected_components(
    u: np.ndarray, v: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, int]:
    """Connected components over an undirected edge list.

    Returns (labels, n_components); labels numbered by first occurrence.
    """
    u = np.ascontiguousarray(u, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    lib = get_lib()
    if lib is None:
        import scipy.sparse as ss
        import scipy.sparse.csgraph as csgraph

        graph = ss.coo_matrix(
            (np.ones(len(u), np.int8), (u, v)), shape=(n_nodes, n_nodes)
        )
        k, raw = csgraph.connected_components(graph, directed=False)
        # Renumber by first occurrence for determinism.
        _, first = np.unique(raw, return_index=True)
        remap = np.empty(k, np.int32)
        remap[raw[np.sort(first)]] = np.arange(k, dtype=np.int32)
        return remap[raw], k
    labels = np.empty(n_nodes, np.int32)
    k = lib.fc_connected_components(
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(u)), ctypes.c_int64(n_nodes),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if k < 0:
        raise ValueError(
            "connected_components got an edge endpoint outside "
            f"[0, {n_nodes})")
    return labels, int(k)
