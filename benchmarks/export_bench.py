"""Export-path micro-benchmark: native CSV formatting + natural sort.

Measures the two host-side export kernels against their Python
fallbacks on synthetic rows shaped like a real run (README "Performance"
section quotes these numbers):

  - ``native.csv_rows`` (C++ ``fc_csv_format_rows_u32``) vs
    ``csv.writer.writerows`` fed the same numpy columns;
  - ``native.natsort_pairs`` on numpy U arrays (zero-copy
    ``fc_natsort_pairs_u32``) vs the per-object packing path.

Pure host benchmark — no accelerator needed.  Usage::

    python benchmarks/export_bench.py [n_rows]      # default 2_000_000

Prints one JSON line.  Byte-for-byte parity between the paths is
asserted here AND enforced by tests/test_export.py; this script only
times.
"""

import csv
import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from falcon_tpu import native  # noqa: E402
from falcon_tpu.store.store import NULL_CHARGE  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    rng = np.random.default_rng(3)
    fns = np.asarray(["file_%03d.mzML" % i for i in rng.integers(0, 50, n)])
    ids = np.asarray(["cluster%d_member%d_scan%d" % (i % 3500, i % 10, i)
                      for i in range(n)])
    charge = rng.integers(2, 4, n).astype(np.int64)
    charge[::97] = int(NULL_CHARGE)
    mz = rng.uniform(101.0, 1500.0, n).astype(np.float32)
    rt = rng.uniform(0.0, 5400.0, n).astype(np.float32)
    cl = rng.integers(-1, 1_000_000, n).astype(np.int64)

    t0 = time.time()
    order = native.natsort_pairs(ids, np.zeros(n, dtype="U1"))
    t_sort_u32 = time.time() - t0
    t0 = time.time()
    order_obj = native.natsort_pairs(ids.tolist(), [""] * n)
    t_sort_obj = time.time() - t0
    assert np.array_equal(order, order_obj)

    t0 = time.time()
    buf = native.csv_rows(fns, ids, charge, int(NULL_CHARGE), mz, rt, cl)
    t_csv_native = time.time() - t0
    t0 = time.time()
    sbuf = io.StringIO()
    w = csv.writer(sbuf, lineterminator="\n")
    charge_str = np.where(charge == NULL_CHARGE, "", charge.astype(str))
    w.writerows(zip(fns, ids, charge_str, mz, rt, cl))
    t_csv_py = time.time() - t0
    assert buf == sbuf.getvalue().encode("utf-8")

    print(json.dumps({
        "n_rows": n,
        "csv_native_s": round(t_csv_native, 2),
        "csv_python_s": round(t_csv_py, 2),
        "csv_speedup": round(t_csv_py / t_csv_native, 2),
        "natsort_u32_s": round(t_sort_u32, 2),
        "natsort_object_s": round(t_sort_obj, 2),
        "parity": "asserted",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
