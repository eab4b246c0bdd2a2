"""Ingest micro-benchmark: native parse+preprocess rate per format.

Measures the C++ scanners (`native/falcon_ingest.cc`,
`native/falcon_mzml.cc`) on synthetic corpora of HCD-like spectra —
the per-core parse+preprocess rates the README "Ingest" section quotes.
Pure host benchmark — no accelerator needed.  Usage::

    python benchmarks/ingest_bench.py [n_spectra]    # default 20_000

Prints one JSON line with spectra/s per format (best of 3 warm runs).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from falcon_tpu import native  # noqa: E402
from falcon_tpu.simulate import make_clustered_spectra, write_mgf  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    if native.get_lib() is None:
        print(json.dumps({"error": "native library unavailable; "
                                   "run `make -C native` first"}))
        return 1
    spectra, _ = make_clustered_spectra(
        n_clusters=n // 13, cluster_size=10, n_noise=n - (n // 13) * 10,
        seed=3,
    )
    tmp = tempfile.mkdtemp()
    from test_fuzz import _write_msp
    from test_native_ingest import (_spectra_to_scans, _write_mzml,
                                    _write_mzxml)

    paths = {"mgf": os.path.join(tmp, "b.mgf"),
             "mzML": os.path.join(tmp, "b.mzML"),
             "mzXML": os.path.join(tmp, "b.mzXML"),
             "msp": os.path.join(tmp, "b.msp")}
    write_mgf(paths["mgf"], spectra)
    _write_mzml(paths["mzML"], spectra)
    _write_mzxml(paths["mzXML"], _spectra_to_scans(spectra))
    _write_msp(paths["msp"], spectra)
    ingest = {"mgf": native.mgf_ingest, "mzML": native.mzml_ingest,
              "mzXML": native.mzxml_ingest, "msp": native.msp_ingest}

    try:
        out = {"n_spectra": len(spectra)}
        for fmt, path in paths.items():
            best = float("inf")
            for _ in range(3):
                t0 = time.time()
                batch = ingest[fmt](path, 5, 250.0, 101.0, 1500.0, 1.5,
                                    0.01, 50, scaling=None)
                best = min(best, time.time() - t0)
                assert len(batch["identifier"]) > 0
            out[f"{fmt}_spectra_per_s"] = round(len(spectra) / best)
            out[f"{fmt}_mb_per_s"] = round(
                os.path.getsize(path) / 1e6 / best)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
