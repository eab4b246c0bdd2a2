"""Smoke run of falcon-tpu's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-3
    python chip_smoke.py --devices 4   # four cards: the --devices path only

Phase 0  environment: the card's name and power limit, JAX and its devices,
         the compile cache directory, and which host library path is active.
Phase 1  the pair-panel kernel (``ops/pairwise.py``) at real widths (P = 64,
         a 2,048-row panel against an 8,192-column bucket, upper triangle on
         and off), compared with the plain XLA reference and the SciPy
         Hungarian oracle, and timed beside XLA's version of the plain code;
         the same for the exact backend's streamed ``condensed_distances``
         over all 8,192 spectra; ``approx_max_k`` against ``lax.top_k`` at
         the k-NN scan's geometry.
Phase 2  ``--backend ann`` (linkage, eps 0.10) through ``falcon_tpu.cli``
         on a corpus of at least 1M spectra in several MGF files, made from
         a seed; charge 2 holds more than 2^19 spectra, so one device block
         is full.  Purity and completeness against the generator's truth.
Phase 3  ``--backend exact`` (complete linkage, distance threshold 0.10) and
         ``--backend ann`` on the 50k bench corpus; ann-vs-exact pair-F1.

With ``--devices 4`` the script runs only the ann CLI with ``--devices 4``
on the Phase-2 corpus and the same run on one card, and requires identical
labels.

Phase 2 runs before Phase 1, so that its peak device memory is its own.
Every check raises, so a failed phase exits non-zero.  The last line of
standard output is a JSON object, printed only when every phase passed.
JAX is imported only under ``__main__``: the ingest pool and the corpus
generator spawn worker processes that re-import this module, and they must
never create a backend (one process per card).
"""

import argparse
import csv
import json
import logging
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
BLOCK_CAP = 2**19  # cluster/ann_engine.device_block_cap's default
# Device blocks end on precursor tolerance gaps, so a full block stops
# short of the cap by less than one gap-free run (a few hundred spectra
# in this corpus); a block within 1% of the cap counts as full.
BLOCK_SLACK = BLOCK_CAP // 100
MIN_SPECTRA = 10**6
# The Phase-2 corpus: 20 MGF files of 52,000 spectra, two thirds of
# charge 2, so charge 2 holds ~694k spectra and fills one device block.
N_FILES = 20
PER_FILE = 52_000


def _smi(*query: str) -> list:
    out = subprocess.run(
        ["nvidia-smi", *query, "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _median_time(fn, runs: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())  # warm: compile and load
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _peak_bytes() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


class _Records(logging.Handler):
    """Keeps the package's log messages, to check which paths ran."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append((record.levelno, record.getMessage()))


# ----------------------------------------------------------------- phase 0
def phase0(n_devices: int) -> dict:
    cards = _smi("--query-gpu=name,power.limit")
    for line in cards:
        print(f"card (nvidia-smi name, power.limit): {line}")
    import jax

    from falcon_tpu import native
    from falcon_tpu.utils.compile_cache import configure_compile_cache

    cache_dir = configure_compile_cache()
    devices = jax.devices()
    print(f"jax {jax.__version__}; devices {devices}")
    print(f"compile cache: {cache_dir}")
    lib = native.get_lib()
    print("host library: "
          + (f"native ({native._LIB_PATH})" if lib is not None
             else "SciPy/Python fallback"))
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {platform!r}")
    if len(devices) < n_devices:
        raise SystemExit(
            f"{n_devices} GPUs requested, {len(devices)} visible")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}


# ----------------------------------------------------------------- phase 1
def _phase1_spectra(n: int = 8192, p: int = 64):
    """n preprocessed spectra, padded to p peaks, in precursor order (as
    the exact engine scores them)."""
    import numpy as np

    from falcon_tpu.preprocess import process_spectrum
    from falcon_tpu.simulate import make_clustered_spectra
    from falcon_tpu.store.store import padded_peaks

    spectra, _ = make_clustered_spectra(
        n_clusters=700, cluster_size=8, n_noise=n - 5600 + 400,
        precursor_classes=200, seed=11,
    )
    rows = [r for s in spectra
            if (r := process_spectrum(s, 5, 250.0, 101.0, 1500.0, 1.5, 0.01,
                                      50, None)) is not None]
    rows.sort(key=lambda r: r["precursor_mz"])
    rows = rows[:n]
    if len(rows) < n:
        raise RuntimeError(f"only {len(rows)} spectra survived preprocessing")
    offsets = np.zeros(n + 1, np.int64)
    offsets[1:] = np.cumsum([len(r["mz"]) for r in rows])
    return padded_peaks(offsets, np.concatenate([r["mz"] for r in rows]),
                        np.concatenate([r["intensity"] for r in rows]), p)


def phase1() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from falcon_tpu.cluster.oracle import cosine_exact
    from falcon_tpu.ops import pairwise

    rows_n, cols_n, frag = 2048, 8192, 0.05
    mz, inten, lengths = _phase1_spectra(cols_n)
    mz_r = jnp.asarray(mz[:rows_n])[None]
    int_r = jnp.asarray(inten[:rows_n])[None]
    mz_c = jnp.asarray(mz)[None]
    int_c = jnp.asarray(inten)[None]
    print(f"phase 1: pair panel {rows_n} x {cols_n}, P = {mz.shape[1]}, "
          f"implementation on this platform: {pairwise.panel_impl()}")
    if pairwise.panel_impl() != "pallas":
        raise RuntimeError("the GPU must select the compiled kernel")
    for upper in (False, True):
        statics = dict(fragment_tol=frag, upper_only=upper)
        compiled = pairwise.panel_scores_triton.lower(
            mz_r, int_r, mz_c, int_c, **statics).compile()
        print(f"  kernel upper_only={upper} memory_analysis: "
              f"{compiled.memory_analysis()}")
        s_k, m_k = pairwise.panel_scores(mz_r, int_r, mz_c, int_c, frag,
                                         upper_only=upper, backend="pallas")
        s_x, m_x = pairwise.panel_scores(mz_r, int_r, mz_c, int_c, frag,
                                         upper_only=upper, backend="xla")
        s_k, m_k = np.asarray(s_k[0]), np.asarray(m_k[0])
        s_x, m_x = np.asarray(s_x[0]), np.asarray(m_x[0])
        err = float(np.abs(s_k - s_x).max())
        n_diff = int((m_k != m_x).sum())
        print(f"  upper_only={upper}: max |kernel - xla| = {err:.3g}, "
              f"match counts differing: {n_diff}, "
              f"pairs scored > 0.5: {int((s_k > 0.5).sum())}")
        if err > 1e-5 or n_diff:
            raise RuntimeError("kernel disagrees with the XLA reference")
        # 40 sampled pairs against the Hungarian optimum: half among the
        # similar pairs, half uniform (upper triangle when upper_only).
        rng = np.random.default_rng(0)
        ii, jj = np.nonzero(s_k > 0.5)
        ok = jj > ii if upper else ii != jj
        take = rng.choice(int(ok.sum()), 20, replace=False)
        pairs = list(zip(ii[ok][take], jj[ok][take]))
        while len(pairs) < 40:
            i, j = rng.integers(0, rows_n), rng.integers(0, cols_n)
            if j > i or not upper:
                pairs.append((i, j))
        worst = 0.0
        for i, j in pairs:
            ref, _ = cosine_exact(mz[i][:lengths[i]], inten[i][:lengths[i]],
                                  mz[j][:lengths[j]], inten[j][:lengths[j]],
                                  frag)
            worst = max(worst, abs(float(s_k[i, j]) - ref))
        print(f"  upper_only={upper}: 40 pairs vs Hungarian oracle, "
              f"max deviation {worst:.3g}")
        if worst > 5e-3:
            raise RuntimeError("kernel deviates from the Hungarian oracle")
        for backend in ("pallas", "xla"):
            t = _median_time(lambda: pairwise.panel_scores(
                mz_r, int_r, mz_c, int_c, frag, upper_only=upper,
                with_matches=False, backend=backend)[0])
            name = "Triton kernel" if backend == "pallas" else "XLA plain"
            print(f"  time {name} upper_only={upper}: median of 5 "
                  f"{t * 1e3:.3f} ms")

    # The exact engine's path for an interval above its grouping limit:
    # 2,048-row panels streamed over the upper triangle of all 8,192
    # spectra, as one condensed distance matrix.
    n_pairs = cols_n * (cols_n - 1) // 2
    for min_matches in (0, 6):
        d_k = pairwise.condensed_distances(mz, inten, frag, min_matches)
        d_x = pairwise.condensed_distances(mz, inten, frag, min_matches,
                                           backend="xla")
        err = float(np.abs(d_k - d_x).max()) if len(d_k) == n_pairs else 1.0
        print(f"  condensed_distances n={cols_n} min_matches={min_matches}: "
              f"{len(d_k)} pairs, max |kernel - xla| = {err:.3g}, "
              f"pairs closer than 0.5: {int((d_k < 0.5).sum())}")
        if len(d_x) != n_pairs or err > 1e-5:
            raise RuntimeError("streamed condensed distances disagree")
    for backend in (None, "xla"):
        t = _median_time(lambda: pairwise.condensed_distances(
            mz, inten, frag, backend=backend))
        name = "Triton kernel" if backend is None else "XLA plain"
        print(f"  time condensed_distances n={cols_n} {name}: median of 5 "
              f"{t:.3f} s")

    # Retrieval at the k-NN scan's geometry: 2^19 query rows, each
    # against a 2,048-column band window, k = n_neighbors_ann = 128.
    sims = jax.random.normal(jax.random.key(0), (BLOCK_CAP, 2048),
                             jnp.float32)
    top = jax.jit(lambda x: jax.lax.top_k(x, 128))
    approx = jax.jit(lambda x: jax.lax.approx_max_k(x, 128,
                                                    recall_target=0.99))
    hlo = approx.lower(sims).compile().as_text()
    ops = sorted({w for w in ("sort", "topk", "custom-call", "reduce-window")
                  if w in hlo.lower()})
    print(f"  approx_max_k compiles to HLO with: {', '.join(ops) or 'none'}")
    for name, fn in (("lax.top_k", top), ("approx_max_k", approx)):
        t = _median_time(lambda: fn(sims))
        print(f"  time {name} (2^19 x 2048, k = 128): median of 5 "
              f"{t * 1e3:.3f} ms")


# ----------------------------------------------------------------- phase 2
def _write_part(args) -> str:
    path, n, seed = args
    from falcon_tpu.simulate import make_clustered_spectra, write_mgf

    n_clusters = n * 7 // 100
    spectra, _ = make_clustered_spectra(
        n_clusters=n_clusters, cluster_size=10,
        n_noise=n - n_clusters * 10, precursor_classes=max(n // 80, 50),
        charges=(2, 2, 3), seed=seed,
    )
    write_mgf(path, spectra)
    return path


def make_corpus(out_dir: str, n_files: int, per_file: int,
                seed: int = 1000) -> list:
    """``n_files`` MGF files of ``per_file`` synthetic spectra each, two
    thirds of charge 2 and one third of charge 3, written by a spawn
    pool (the workers import no JAX)."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(os.path.join(out_dir, f"part{i:03d}.mgf"), per_file, seed + i)
            for i in range(n_files)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(n_files, os.cpu_count() or 1)) as pool:
        return pool.map(_write_part, jobs)


def _read_csv(path: str) -> dict:
    """{(file, spectrum id): cluster label} from a cluster CSV."""
    with open(path) as f:
        rows = [r for r in csv.reader(f) if not r[0].startswith("#")]
    return {(r[0], r[1]): int(r[5]) for r in rows[1:]}


def _quality(labels: dict) -> tuple:
    import numpy as np

    from falcon_tpu import metrics

    keys = sorted(labels)
    truth_keys = [(f, i.split("_scan")[0].split("_member")[0])
                  for f, i in keys]
    ids = {t: n for n, t in enumerate(sorted(set(truth_keys)))}
    truth = np.asarray([ids[t] for t in truth_keys])
    got = np.asarray([labels[k] for k in keys])
    return (metrics.cluster_purity(got, truth),
            metrics.cluster_completeness(got, truth))


def _run_cli(args: list) -> tuple:
    """Runs the CLI in this process; returns (wall seconds, log records,
    profiler phases)."""
    from falcon_tpu import cli
    from falcon_tpu.utils.profiling import profiler

    records = _Records()
    logging.getLogger("falcon_tpu").addHandler(records)
    try:
        t0 = time.perf_counter()
        rc = cli.main(args)
        wall = time.perf_counter() - t0
    finally:
        logging.getLogger("falcon_tpu").removeHandler(records)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}: {args}")
    return wall, records.messages, profiler.summary()


def _check_size(n: int, logs: list) -> None:
    """Requires at least MIN_SPECTRA clustered spectra and one device
    block filled to the cap, from the engine's block-split log lines."""
    blocks = []
    for _, m in logs:
        if f"device blocks (cap {BLOCK_CAP}), rows per block: " in m:
            print(f"  {m}")
            blocks += [int(r) for r in m.rsplit(": ", 1)[1].split(",")]
    print(f"  {n} spectra clustered; largest device block {max(blocks or [0])}"
          f" rows (cap {BLOCK_CAP})")
    if n < MIN_SPECTRA:
        raise RuntimeError(f"corpus too small: {n} spectra clustered")
    if max(blocks or [0]) < BLOCK_CAP - BLOCK_SLACK:
        raise RuntimeError("no device block filled to the 2^19-row cap")


def phase2(files: list) -> None:
    out = os.path.join(WORK, "ann1m")
    wall, logs, _ = _run_cli([
        *files, out, "--work_dir", os.path.join(WORK, "ann1m_work"),
        "--backend", "ann", "--eps", "0.10", "--overwrite",
    ])
    labels = _read_csv(out + ".csv")
    n = len(labels)
    purity, completeness = _quality(labels)
    peak = _peak_bytes()
    holders = _smi("--query-compute-apps=pid")
    print(f"phase 2: ann backend on {n} spectra in {len(files)} MGF files")
    print(f"  wall {wall:.3f} s, {n / wall:.1f} spectra/s")
    print(f"  purity {purity:.4f}, completeness {completeness:.4f}")
    print(f"  peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)")
    print(f"  processes holding the card: {len(holders)} {holders}")
    _check_size(n, logs)
    if purity < 0.99:
        raise RuntimeError(f"purity {purity:.4f} < 0.99")
    if len(holders) > 1:
        raise RuntimeError("more than one process holds the card")


# ----------------------------------------------------------------- phase 3
def phase3() -> None:
    import bench

    path = bench._ensure_dataset()
    work = os.path.join(WORK, "bench50k_work")
    out_ann = os.path.join(WORK, "bench50k_ann")
    out_exact = os.path.join(WORK, "bench50k_exact")
    wall_ann, _, _ = _run_cli([path, out_ann, "--work_dir", work,
                               "--backend", "ann", "--eps", "0.10",
                               "--overwrite"])
    # The exact run resumes from the ingested store, as bench.py does.
    wall_exact, _, phases = _run_cli([
        path, out_exact, "--work_dir", work, "--backend", "exact",
        "--distance_threshold", "0.10",
    ])
    agreement = bench._label_agreement(out_ann + ".csv", out_exact + ".csv")
    print(f"phase 3: 50k bench corpus; ann wall {wall_ann:.3f} s "
          f"(ingest included), exact wall {wall_exact:.3f} s "
          f"(ingest resumed)")
    print(f"  ann-vs-exact pair F1 {agreement['f1']:.5f} (precision "
          f"{agreement['precision']:.5f}, recall {agreement['recall']:.5f})")
    if agreement["f1"] < 0.999:
        raise RuntimeError(f"ann-vs-exact pair F1 {agreement['f1']:.5f}")


# ------------------------------------------------------------ four cards
def phase_devices(files: list, n_devices: int) -> None:
    out_n = os.path.join(WORK, f"ann_dev{n_devices}")
    out_1 = os.path.join(WORK, "ann_dev1")
    wall_n, logs, phases = _run_cli([
        *files, out_n, "--work_dir", os.path.join(WORK, "dev_work"),
        "--backend", "ann", "--eps", "0.10", "--overwrite",
        "--devices", str(n_devices),
    ])
    fallbacks = [m for lvl, m in logs if lvl >= logging.WARNING
                 and ("single-device" in m or "falling back" in m)]
    round_robin = [m for _, m in logs if "round-robin" in m]
    sharded = [k for k in phases if "sharded pipeline" in k]
    print(f"devices {n_devices}: wall {wall_n:.3f} s")
    for m in round_robin:
        print(f"  {m}")
    print(f"  sharded-pipeline phases: {sharded}")
    _check_size(len(_read_csv(out_n + ".csv")), logs)
    if fallbacks:
        raise RuntimeError(f"multi-device path fell back: {fallbacks}")
    if not round_robin and not sharded:
        raise RuntimeError("no multi-device path ran")
    wall_1, _, _ = _run_cli([
        *files, out_1, "--work_dir", os.path.join(WORK, "dev_work"),
        "--backend", "ann", "--eps", "0.10", "--overwrite",
    ])
    print(f"devices 1: wall {wall_1:.3f} s")
    a, b = _read_csv(out_n + ".csv"), _read_csv(out_1 + ".csv")
    same = a.keys() == b.keys() and all(a[k] == b[k] for k in a)
    print(f"  labels identical between {n_devices} cards and 1 card: "
          f"{same} ({len(a)} spectra)")
    if not same:
        raise RuntimeError("multi-device labels differ from one card")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1,
                        help="run only the --devices N path (N > 1)")
    args = parser.parse_args(argv)

    device = phase0(args.devices)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        files = make_corpus(os.path.join(WORK, "corpus"), N_FILES, PER_FILE)
        print(f"corpus: {N_FILES} x {PER_FILE} spectra written in "
              f"{time.perf_counter() - t0:.1f} s")
        if args.devices > 1:
            phase_devices(files, args.devices)
        else:
            # Phase 2 first: its peak_bytes_in_use must not include
            # Phase 1's test arrays (the statistic is a process peak).
            phase2(files)
            phase1()
            phase3()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
