"""Pipeline driver / CLI entry point.

Reproduces the observable behavior of the reference's ``falcon.main``
(``falcon/falcon.py:33-244``): logging setup, config echo, work-dir
lifecycle, output-exists/overwrite gate (exit 1), ingest-resume via the
charge cache, per-charge clustering with globally disjoint labels,
natural-sorted CSV export with the full config header, and optional
medoid-MGF export — with the clustering core dispatched to the device
engines (``cluster/engine.py`` for the exact backend, ``cluster/ann_engine.py``
for the published vectorize→hash→IVF→density algorithm).
"""

import logging
import os
import shutil
import sys
import tempfile
from typing import List, Union

import numpy as np

from . import __version__, seed
from .config import config
from .store.store import SpectrumStore
from .utils.profiling import profiler

logger = logging.getLogger("falcon_tpu")

seed.set_seeds()


def main(args: Union[str, List[str], None] = None,
         _collect: Union[dict, None] = None) -> int:
    """CLI entry point.  Wraps the pipeline so an auto-created temp
    work_dir (no --work_dir given) is removed on EVERY exit path —
    early aborts and exceptions included, not just success.

    ``_collect`` is the library-API hook (``falcon_tpu.api``): a dict the
    pipeline fills with in-memory results (``assignments``,
    ``representatives``).  In collect mode user-input errors RAISE
    instead of returning an exit code, and the CSV/MGF export only runs
    when ``_collect["write_outputs"]`` is true."""
    cleanup: list = []
    try:
        return _run(args, cleanup, _collect)
    finally:
        for path in cleanup:
            shutil.rmtree(path, ignore_errors=True)


def _run(args: Union[str, List[str], None], cleanup: list,
         collect: Union[dict, None] = None) -> int:
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    # Configure logging (reference falcon.py:34-50).  Idempotent: repeated
    # main() calls in one process (library use, benchmarks) must not stack
    # handlers and duplicate every line.
    logging.captureWarnings(True)
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    if not any(getattr(h, "_falcon_tpu", False) for h in root.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler._falcon_tpu = True
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(
            logging.Formatter(
                "{asctime} {levelname} [{name}/{processName}] "
                "{module}.{funcName} : {message}",
                style="{",
            )
        )
        root.addHandler(handler)
    logging.getLogger("jax").setLevel(logging.WARNING)

    config.parse(args)
    logger.info("falcon-tpu version %s", str(__version__))
    for key in (
        "work_dir", "overwrite", "export_representatives", "precursor_tol",
        "rt_tol", "fragment_tol", "linkage", "distance_threshold",
        "min_matched_peaks", "batch_size", "min_peaks", "min_mz_range",
        "min_mz", "max_mz", "remove_precursor_tol", "min_intensity",
        "max_peaks_used", "scaling", "backend", "cluster_method", "eps",
        "low_dim", "n_neighbors", "n_neighbors_ann", "n_probe",
        "min_samples", "ann_index", "hash_seed", "rerank",
        "representative_method",
        "consensus_min_fraction", "devices", "profile",
    ):
        logger.debug("%s = %s", key, config[key])

    if config.work_dir is None:
        config.work_dir = tempfile.mkdtemp()
        cleanup.append(config.work_dir)
    elif os.path.isdir(config.work_dir):
        logging.warning(
            "Working directory %s already exists, previous results might "
            "get overwritten", config.work_dir,
        )
    os.makedirs(config.work_dir, exist_ok=True)
    os.makedirs(os.path.join(config.work_dir, "spectra"), exist_ok=True)

    # Output-exists / overwrite gate (reference falcon.py:89-122).
    # Skipped when the library API runs without file outputs — nothing
    # would be written, so an existing file cannot be clobbered.
    write_outputs = collect is None or bool(collect.get("write_outputs"))
    exit_exists = False
    if write_outputs:
        for ext, desc in ((".csv", "cluster assignments"),
                          (".mgf", "cluster representatives")):
            path = f"{config.output_filename}{ext}"
            if os.path.isfile(path):
                if config.overwrite:
                    logger.warning(
                        "Output file %s (%s) already exists and will be "
                        "overwritten", path, desc,
                    )
                    os.remove(path)
                else:
                    logger.error(
                        "Output file %s (%s) already exists, aborting...",
                        path, desc,
                    )
                    exit_exists = True
    if exit_exists:
        logging.shutdown()
        if collect is not None:
            raise FileExistsError(
                f"Output file(s) for {config.output_filename!r} already "
                "exist; pass overwrite=True to replace them"
            )
        return 1

    from .preprocess import get_dim

    _, mz_min, mz_max = get_dim(
        config.min_mz, config.max_mz, config.fragment_tol
    )
    process_kwargs = dict(
        min_peaks=config.min_peaks,
        min_mz_range=config.min_mz_range,
        mz_min=mz_min,
        mz_max=mz_max,
        remove_precursor_tolerance=config.remove_precursor_tol,
        min_intensity=config.min_intensity,
        max_peaks_used=config.max_peaks_used,
        scaling=None if config.scaling == "off" else config.scaling,
    )

    store = SpectrumStore(os.path.join(config.work_dir, "spectra"))
    if config.overwrite:
        store.clear()

    profiler.reset()
    if config.profile:
        profiler.start_trace(config.profile)

    # Ingest-resume point (reference falcon.py:143-149).
    charges = store.load_charges()
    if charges is None:
        # The charge cache is the commit record of a completed ingest.
        # If it is absent but the store has content, a previous run
        # crashed mid-ingest — re-ingesting on top would collide with
        # (or duplicate) the partial shards, so start the store fresh.
        if os.listdir(store.root):
            logger.warning(
                "Found a partially-written spectrum store (no charge "
                "cache) in %s; discarding it and re-ingesting",
                store.root,
            )
            store.clear()
        from . import ingest

        with profiler.phase("ingest"):
            try:
                charges = ingest.prepare_spectra(
                    store, config.input_filenames, process_kwargs
                )
            except ValueError as e:
                # User-input errors (no files matched, non-existing
                # peak file, unknown extension — raised here or inside
                # an ingest worker): report cleanly, exit 1, instead of
                # leaking a traceback (the library-level readers still
                # raise for API callers, tests/test_ms_io.py).
                logger.error(str(e))
                logging.shutdown()
                if collect is not None:
                    raise
                return 1

    # Import the engine lazily: it pulls in JAX, and ingest worker
    # processes must never create a backend (one process per card).
    from .cluster import engine

    labels_by_charge: list = []
    current_label, representatives = 0, []
    total_rows = total_clusters = 0
    datasets = []
    for charge in charges:
        # A charge bucket whose persisted store is missing or damaged
        # (e.g. a corrupted --work_dir being resumed) is dropped with an
        # error and the run continues, mirroring the reference dropping
        # an unopenable Lance dataset (falcon/falcon.py:315-322).
        try:
            dataset = store.dataset(charge)
            dataset.validate()
            if dataset.count_rows() == 0:
                continue
        except (ValueError, OSError) as exc:
            logger.error("Failed to open dataset for charge %s: %s",
                         charge, exc)
            continue
        datasets.append((charge, dataset))

    # Charge buckets are independent; when every bucket is small enough
    # that two fit on the device at once, the per-charge pipelines run
    # in a 2-deep thread pipeline so one charge's host phases (refine,
    # label bookkeeping) overlap the other's device work.  Label
    # offsetting and representative extraction stay sequential below.
    # The threshold matches the device-block cap: the block pipeline
    # already keeps two cap-sized blocks resident (ann_engine), so two
    # sub-cap charges fit the same memory envelope.  Above the cap a
    # charge pipelines its own blocks instead.
    from .cluster.ann_engine import device_block_cap

    overlap_cap = device_block_cap()
    overlap = (
        config.backend == "ann"
        and len(datasets) > 1
        and all(d.count_rows() <= overlap_cap for _, d in datasets)
        and os.environ.get("FALCON_TPU_NO_CHARGE_OVERLAP") != "1"
    )
    futures = {}
    if overlap:
        from concurrent.futures import ThreadPoolExecutor

        charge_pool = ThreadPoolExecutor(max_workers=2)
        for charge, dataset in datasets:
            futures[charge] = charge_pool.submit(
                _generate_for_charge, dataset, mz_min, mz_max
            )

    for charge, dataset in datasets:
        with profiler.phase(f"cluster charge {charge}"):
            if charge in futures:
                clusters, medoids = futures[charge].result()
            elif config.backend == "ann":
                clusters, medoids = _generate_for_charge(
                    dataset, mz_min, mz_max
                )
            else:
                clusters, medoids = engine.generate_clusters(
                    dataset,
                    config.linkage,
                    config.distance_threshold,
                    config.min_matched_peaks,
                    config.precursor_tol[0],
                    config.precursor_tol[1],
                    config.rt_tol,
                    config.fragment_tol,
                    config.batch_size,
                    max_peaks=config.max_peaks_used,
                    devices=config.devices,
                )
        if (config.export_representatives
                and config.representative_method == "consensus"):
            meta = dataset.read_metadata(
                columns=("precursor_mz", "retention_time")
            )
            representatives.extend(
                _consensus_representatives(
                    dataset, meta, clusters, charge, current_label,
                    mz_min,
                )
            )
            del meta
        # Globally disjoint labels across charges (reference
        # falcon.py:189-193).
        clusters = clusters + current_label
        current_label = int(np.amax(clusters)) + 1
        total_rows += len(clusters)
        total_clusters += len(np.unique(clusters))
        # Only the int64 labels stay resident per charge; the metadata
        # columns stream from the store at export time (falcon_tpu/
        # export.py), so peak RSS no longer scales with the corpus.
        labels_by_charge.append((dataset, clusters.astype(np.int64)))
        if (config.export_representatives
                and config.representative_method == "medoid"):
            representatives.extend(dataset.take(medoids))

    if futures:
        charge_pool.shutdown(wait=True)

    if not labels_by_charge:
        logger.error("No spectra found to cluster")
        logging.shutdown()
        if collect is not None:
            raise ValueError("No spectra found to cluster")
        return 1

    def _collect_results() -> None:
        # Library API: in-memory results, one row per clustered spectrum
        # in charge-major store order (the CSV's natural-sorted order is
        # an export-time concern; API callers sort as they see fit).
        # Runs AFTER any file export so the full-corpus metadata copy
        # never coexists with the export's working set (export streams
        # at O(largest file) RSS, falcon_tpu/export.py).
        cols = {c: [] for c in ("filename", "identifier",
                                "precursor_charge", "precursor_mz",
                                "retention_time")}
        labs = []
        for ds, labels in labels_by_charge:
            meta = ds.read_metadata()
            for c in cols:
                cols[c].append(meta[c])
            labs.append(labels)
        assignments = {c: np.concatenate(v) for c, v in cols.items()}
        assignments["cluster"] = np.concatenate(labs)
        collect["assignments"] = assignments
        collect["representatives"] = (
            _rep_spectra(representatives)
            if config.export_representatives else []
        )

    if not write_outputs:
        _collect_results()
        profiler.stop_trace()
        profiler.log_summary()
        logging.shutdown()
        return 0

    logger.info(
        "Export cluster assignments of %d spectra to %d unique clusters "
        "to output file %s",
        total_rows, total_clusters, f"{config.output_filename}.csv",
    )
    export_phase = profiler.phase("export")
    export_phase.__enter__()
    # Streaming per-file export (falcon_tpu/export.py): the natural
    # (filename, spectrum_id) order is produced one input file at a
    # time from the store's per-file shard namespaces, so export RSS is
    # O(largest file), not O(corpus).
    from concurrent.futures import ThreadPoolExecutor as _ExportPool

    from .export import export_cluster_csv

    # Futures, not bare threads: a bare Thread swallows exceptions, so
    # a failed export (disk full, corrupt shard) would still exit 0
    # with a truncated CSV; future.result() re-raises in main.
    # Outputs publish atomically: written to a same-directory .partial
    # path and renamed only on success, so a crash mid-export never
    # leaves a truncated out.csv/.mgf behind to trip the overwrite gate.
    csv_path = f"{config.output_filename}.csv"
    mgf_path = f"{config.output_filename}.mgf"
    csv_tmp, mgf_tmp = csv_path + ".partial", mgf_path + ".partial"
    for stale in (csv_tmp, mgf_tmp):
        if os.path.exists(stale):
            os.remove(stale)
    with _ExportPool(max_workers=2) as export_pool:
        csv_future = export_pool.submit(
            export_cluster_csv, csv_tmp, _write_manifest, labels_by_charge,
        )
        if config.export_representatives:
            # mgf_io directly: the extension dispatch in ms_io would
            # reject the ".partial" temp name (the real name is .mgf).
            from .ms_io import mgf_io

            spectra = _rep_spectra(representatives)
            logger.info(
                "Export %d cluster representative spectra to output "
                "file %s", len(spectra), mgf_path,
            )
            export_pool.submit(
                mgf_io.write_spectra, mgf_tmp, spectra,
            ).result()
        csv_future.result()
        # Publish together, only once every export succeeded.
        os.replace(csv_tmp, csv_path)
        if config.export_representatives:
            os.replace(mgf_tmp, mgf_path)
    export_phase.__exit__(None, None, None)

    if collect is not None:
        _collect_results()

    profiler.stop_trace()
    profiler.log_summary()

    logging.shutdown()
    return 0


def _rep_spectra(representatives: List[dict]) -> List:
    """Representative rows (medoid ``dataset.take`` rows or consensus
    rows) as :class:`Spectrum` objects, shared by the MGF export and the
    library API."""
    from .ms_io.containers import Spectrum

    return [
        Spectrum(
            r["identifier"], r["precursor_mz"],
            r["precursor_charge"], r["mz"], r["intensity"],
            r["retention_time"], r["filename"],
        )
        for r in representatives
    ]


def _generate_for_charge(dataset, mz_min, mz_max):
    """ann-engine clustering of one charge with the config's settings
    (used by the overlapped per-charge pipeline)."""
    from .cluster import ann_engine

    return ann_engine.generate_clusters(
        dataset,
        eps=config.eps,
        min_samples=config.min_samples,
        cluster_method=config.cluster_method,
        linkage=config.linkage,
        min_matches=config.min_matched_peaks,
        precursor_tol_mass=config.precursor_tol[0],
        precursor_tol_mode=config.precursor_tol[1],
        rt_tol=config.rt_tol,
        fragment_tol=config.fragment_tol,
        batch_size=config.batch_size,
        low_dim=config.low_dim,
        n_neighbors=config.n_neighbors,
        n_neighbors_ann=config.n_neighbors_ann,
        n_probe=config.n_probe,
        hash_seed=config.hash_seed,
        min_mz=mz_min,
        max_mz=mz_max,
        max_peaks=config.max_peaks_used,
        ann_index=config.ann_index,
        rerank=config.rerank,
        devices=config.devices,
    )


def _consensus_representatives(
    dataset, meta, labels: np.ndarray, charge, label_offset: int,
    mz_min: float,
) -> List[dict]:
    """Consensus representative rows for one charge bucket.

    Builds one merged spectrum per cluster on device
    (``ops/consensus.py``); cluster metadata (precursor m/z, retention
    time) is the member mean, and the identifier records the global
    cluster label.
    """
    from .ops.consensus import consensus_spectra

    offsets, mz_flat, int_flat = dataset.read_peaks()
    cons = consensus_spectra(
        offsets, mz_flat, int_flat, labels,
        config.fragment_tol, mz_min,
        min_fraction=config.consensus_min_fraction,
        max_peaks=config.max_peaks_used,
    )
    pmz = np.asarray(meta["precursor_mz"], np.float64)
    rt = np.asarray(meta["retention_time"], np.float64)
    # Per-cluster member means in one pass over the labels (a
    # labels == label scan per cluster is O(n_clusters * n), which at
    # 25M rows dominated representative extraction).
    clustered = labels >= 0
    member_labels = labels[clustered]
    counts = np.bincount(member_labels).astype(np.float64)
    pmz_mean = np.bincount(member_labels, weights=pmz[clustered]) / counts
    rt_mean = np.bincount(member_labels, weights=rt[clustered]) / counts
    rows = []
    for label in sorted(cons):
        mz, intensity = cons[label]
        rows.append(
            {
                "identifier": f"consensus_cluster{label_offset + label}",
                "precursor_mz": float(pmz_mean[label]),
                "precursor_charge": charge,
                "retention_time": float(rt_mean[label]),
                "mz": mz,
                "intensity": intensity,
                "filename": "",
            }
        )
    return rows


def _write_manifest(f_out) -> None:
    """'#'-prefixed run-manifest header (reference ``_write_cluster_info``,
    ``falcon/falcon.py:483-524``; same keys, same order, same
    formatting).  The cluster rows themselves stream after the header
    (``falcon_tpu/export.py``)."""
    f_out.write(f"# falcon-tpu version {__version__}\n")
    f_out.write(f"# work_dir = {config.work_dir}\n")
    f_out.write(f"# overwrite = {config.overwrite}\n")
    f_out.write(
        f"# export_representatives = {config.export_representatives}\n"
    )
    f_out.write(
        f"# precursor_tol = {config.precursor_tol[0]:.2f} "
        f"{config.precursor_tol[1]}\n"
    )
    f_out.write(f"# rt_tol = {config.rt_tol}\n")
    f_out.write(f"# fragment_tol = {config.fragment_tol:.2f}\n")
    f_out.write(f"# linkage = {config.linkage}\n")
    f_out.write(
        f"# distance_threshold = {config.distance_threshold:.3f}\n"
    )
    f_out.write(f"# min_matched_peaks = {config.min_matched_peaks}\n")
    f_out.write(f"# batch_size = {config.batch_size}\n")
    f_out.write(f"# min_peaks = {config.min_peaks}\n")
    f_out.write(f"# min_mz_range = {config.min_mz_range:.2f}\n")
    f_out.write(f"# min_mz = {config.min_mz:.2f}\n")
    f_out.write(f"# max_mz = {config.max_mz:.2f}\n")
    f_out.write(
        f"# remove_precursor_tol = {config.remove_precursor_tol:.2f}\n"
    )
    f_out.write(f"# min_intensity = {config.min_intensity:.2f}\n")
    f_out.write(f"# max_peaks_used = {config.max_peaks_used}\n")
    f_out.write(f"# scaling = {config.scaling}\n")
    # falcon-tpu additions (after the reference's 17 keys).  The
    # manifest is a COMPLETE run record (like the reference's,
    # falcon/falcon.py:492-522): every option that can change the
    # output appears, so a run is reproducible from its CSV alone.
    f_out.write(f"# backend = {config.backend}\n")
    if config.export_representatives:
        f_out.write(
            f"# representative_method = "
            f"{config.representative_method}\n"
        )
        if config.representative_method == "consensus":
            f_out.write(
                f"# consensus_min_fraction = "
                f"{config.consensus_min_fraction}\n"
            )
    if config.backend == "ann":
        f_out.write(f"# cluster_method = {config.cluster_method}\n")
        f_out.write(f"# eps = {config.eps}\n")
        f_out.write(f"# low_dim = {config.low_dim}\n")
        f_out.write(f"# n_neighbors = {config.n_neighbors}\n")
        f_out.write(f"# n_neighbors_ann = {config.n_neighbors_ann}\n")
        f_out.write(f"# n_probe = {config.n_probe}\n")
        f_out.write(f"# min_samples = {config.min_samples}\n")
        f_out.write(f"# ann_index = {config.ann_index}\n")
        f_out.write(f"# hash_seed = {config.hash_seed}\n")
        f_out.write(f"# rerank = {config.rerank}\n")
    f_out.write(f"# devices = {config.devices}\n")
    f_out.write("#\n")
