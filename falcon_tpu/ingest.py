"""Peak-file ingest: parallel parsing + preprocessing into the store.

Mirrors the reference's ingest/partition subsystem
(``falcon/falcon.py:247-480``): peak files are parsed and preprocessed by
a pool of worker processes (one task per file, pool size
min(#files, #cpus), reference ``falcon.py:267``), and the processed
spectra are appended in 10k batches to per-charge datasets.

This module deliberately imports no JAX so ingest worker processes never
create a backend: the parent process is the one process on the card (a
second JAX process would reserve its memory too).
"""

import glob
import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .ms_io import ms_io
from .preprocess import spectrum as prep
from .store.store import SpectrumStore

logger = logging.getLogger("falcon_tpu")

FileResult = Tuple[Union[List[dict], Dict[str, np.ndarray]], int]


def read_and_process_file(
    filename: str, process_kwargs: Dict, allow_native: bool = True
) -> FileResult:
    """Parse one peak file and preprocess its spectra.

    Returns (result, low-quality count) where result is either a columnar
    batch dict (the native C++ fast path — parse + the full preprocessing
    chain for all four formats: MGF and MSP in
    ``native/falcon_ingest.cc``, mzML/mzXML in ``native/falcon_mzml.cc``)
    or a list of processed
    spectrum dicts (the pure-Python fallback when the native library is
    unavailable or returns nothing for a non-empty file).  Mirrors
    reference ``_read_spectra`` (``falcon/falcon.py:362-392``), including
    storing the absolute filename on each spectrum.  A gzipped input is
    decompressed to a temp file once so the native fast path applies;
    the ORIGINAL ``.gz`` path is what lands in the filename metadata.
    """
    filename = os.path.abspath(filename)
    tmp = ms_io.decompress_to_temp(filename)
    try:
        return _read_processed(tmp or filename, filename, process_kwargs,
                               allow_native)
    finally:
        if tmp is not None:
            os.remove(tmp)


def _read_processed(
    parse_path: str, record_filename: str, process_kwargs: Dict,
    allow_native: bool = True,
) -> FileResult:
    """Core of :func:`read_and_process_file`: parse ``parse_path`` (an
    on-disk, already-decompressed peak file) while recording
    ``record_filename`` as each spectrum's origin."""
    filename = record_filename
    lower = parse_path.lower()
    native_fmt = next((fmt for fmt in (".mgf", ".mzml", ".mzxml", ".msp")
                       if lower.endswith(fmt)), None)
    if allow_native and native_fmt:
        from . import native

        ingest_fn = {".mgf": native.mgf_ingest,
                     ".mzml": native.mzml_ingest,
                     ".mzxml": native.mzxml_ingest,
                     ".msp": native.msp_ingest}[native_fmt]
        batch = ingest_fn(parse_path, **process_kwargs)
        if (
            batch is not None
            and batch.get("n_read", 1) == 0
            and batch.get("n_blocks", 0) == 0
            and not batch.get("truncated")
            and os.path.getsize(parse_path) > 0
        ):
            # The native scanner found no spectrum ELEMENTS in a
            # non-empty file (e.g. unusual whitespace/namespacing in the
            # XML): fall back to the Python reader instead of silently
            # dropping the file's spectra.  n_blocks > 0 with n_read == 0
            # means the scanner DID see the elements and the file
            # legitimately has no usable spectra (e.g. MS1-only) — no
            # fallback re-parse then.
            logger.warning(
                "Native parser found no spectra in non-empty file %s; "
                "falling back to the Python reader", filename,
            )
            batch = None
        if batch is not None:
            if batch.get("truncated"):
                logger.warning(
                    "Failed to read file %s: truncated document "
                    "(parsed %d complete spectra)",
                    filename, batch["n_read"],
                )
            if batch.get("n_unsupported", 0) > 0:
                # Mirrors the Python readers' once-per-file warning so a
                # fully numpress-compressed file is never silently empty.
                logger.warning(
                    "Skipped %d spectra with unsupported binary "
                    "compression (e.g. MS-Numpress) in %s",
                    batch["n_unsupported"], filename,
                )
            n = len(batch["precursor_mz"])
            batch["filename"] = np.repeat(np.array([filename]), n)
            return batch, batch["n_low_quality"]
    low_quality_counter = 0
    spectra = []
    for spec in ms_io.get_spectra(parse_path):
        spec.filename = filename
        processed = prep.process_spectrum(spec, **process_kwargs)
        if processed is None:
            low_quality_counter += 1
        else:
            spectra.append(processed)
    return spectra, low_quality_counter


# Files below this size are not worth splitting (range-parse overhead
# plus thread startup would exceed the parse itself).
_RANGE_MIN_BYTES = 16 * 2**20
_RANGE_TARGET_BYTES = 8 * 2**20


def _read_file_ranges(
    filename: str, fmt: str, process_kwargs: Dict, budget: int,
    record_filename: Optional[str] = None,
) -> Optional[Tuple[List[dict], int]]:
    """Parse one large peak file with ``budget`` concurrent native range
    calls.

    The native range parsers release the GIL, so a thread pool gives
    real parse parallelism without process-spawn cost; per-range batches
    concatenate to the whole-file parse exactly (ownership by BEGIN IONS
    line offset for MGF and Name: line offset for MSP —
    ``native/falcon_ingest.cc`` — and by spectrum/scan open-tag offset
    for mzML/mzXML — ``native/falcon_mzml.cc``).  Returns (columnar batches in file
    order, low-quality count), or None when the native range entry is
    unavailable (caller falls back to the single-range path).
    """
    from concurrent.futures import ThreadPoolExecutor

    from . import native

    if record_filename is None:
        record_filename = filename
    ingest_fn = {".mgf": native.mgf_ingest,
                 ".mzml": native.mzml_ingest,
                 ".mzxml": native.mzxml_ingest,
                 ".msp": native.msp_ingest}[fmt]
    size = os.path.getsize(filename)
    n_ranges = min(budget, max(size // _RANGE_TARGET_BYTES, 1))
    if n_ranges <= 1:
        return None
    bounds = [size * i // n_ranges for i in range(n_ranges + 1)]
    with ThreadPoolExecutor(max_workers=n_ranges) as pool:
        batches = list(pool.map(
            lambda i: ingest_fn(
                filename, start=bounds[i], end=bounds[i + 1],
                **process_kwargs,
            ),
            range(n_ranges),
        ))
    if any(b is None for b in batches):
        return None
    n_read = sum(b["n_read"] for b in batches)
    # n_blocks > 0 with n_read == 0 = legitimately empty (e.g. MS1-only):
    # fall through and return the empty batches without re-parsing the
    # file two more times.
    if (n_read == 0 and size > 0
            and sum(b.get("n_blocks", 0) for b in batches) == 0):
        return None  # unusual layout: let the single-range path decide
    if any(b.get("truncated") for b in batches):
        logger.warning(
            "Failed to read file %s: truncated document "
            "(parsed %d complete spectra)", filename, n_read,
        )
    n_unsupported = sum(b.get("n_unsupported", 0) for b in batches)
    if n_unsupported > 0:
        logger.warning(
            "Skipped %d spectra with unsupported binary compression "
            "(e.g. MS-Numpress) in %s", n_unsupported, filename,
        )
    for b in batches:
        b["filename"] = np.repeat(np.array([record_filename]),
                                  len(b["precursor_mz"]))
    lqc = sum(b["n_low_quality"] for b in batches)
    return [b for b in batches if len(b["precursor_mz"])], lqc


def ingest_file_to_store(
    filename: str,
    file_index: int,
    store_root: str,
    process_kwargs: Dict,
    range_budget: int = 1,
) -> Tuple[List[str], int, int]:
    """Worker entry: parse + preprocess one file and write shards
    directly into the store (no spectra cross the process boundary —
    shard names are namespaced by the input file index, so concurrent
    writers never collide and runs stay deterministic).

    ``range_budget`` > 1 lets a large file (any supported format)
    parse as that many concurrent byte ranges (GIL-released native calls
    on threads) when the pool has spare CPUs — the single-big-file case
    the reference's one-process-per-file layout
    (``falcon/falcon.py:267``) leaves serial.

    Returns (charge keys written, spectra kept, low-quality count).
    """
    filename = os.path.abspath(filename)
    store = SpectrumStore(store_root)
    writer = store.writer(batch_size=10_000,
                          shard_prefix=f"{file_index:04d}_")
    result: Union[List[dict], Dict[str, np.ndarray], None] = None
    lqc = 0
    # Gzipped inputs decompress ONCE here so both the range-parallel
    # and single-range paths parse the same temp file; the original
    # .gz path is what the store records.
    tmp = ms_io.decompress_to_temp(filename)
    parse_path = tmp or filename
    try:
        lower = parse_path.lower()
        fmt = next((f for f in (".mgf", ".mzml", ".mzxml", ".msp")
                    if lower.endswith(f)), None)
        if (range_budget > 1 and fmt is not None
                and os.path.getsize(parse_path) >= _RANGE_MIN_BYTES):
            ranged = _read_file_ranges(parse_path, fmt, process_kwargs,
                                       range_budget,
                                       record_filename=filename)
            if ranged is not None:
                batches, lqc = ranged
                charges: set = set()
                n_kept = 0
                for batch in batches:  # file order -> deterministic shards
                    n_kept += len(batch["precursor_mz"])
                    charges.update(writer.add_batch(batch))
                writer.close()
                return sorted(charges), n_kept, lqc
        result, lqc = _read_processed(parse_path, filename, process_kwargs)
    finally:
        if tmp is not None:
            os.remove(tmp)
    charges = set()
    if isinstance(result, dict):
        n_kept = len(result["precursor_mz"])
        charges.update(writer.add_batch(result))
    else:
        n_kept = len(result)
        from .store.store import charge_key

        for spec in result:
            charges.add(charge_key(spec["precursor_charge"]))
            writer.add(spec)
    writer.close()
    return sorted(charges), n_kept, lqc


def prepare_spectra(
    store: SpectrumStore,
    input_patterns: List[str],
    process_kwargs: Dict,
    max_workers: Optional[int] = None,
) -> List[Optional[int]]:
    """Read all input files into per-charge datasets; returns the charges.

    Mirrors reference ``_prepare_spectra`` (``falcon/falcon.py:247-328``):
    glob expansion, process-parallel parsing, 10k-batch appends, per-charge
    partitioning (a ``None`` charge gets its own bucket), and the
    read/skip counters.  Workers write shards directly (one shard
    namespace per input file) instead of shipping spectra back through
    the process boundary.
    """
    input_filenames = [
        fn for pattern in input_patterns for fn in sorted(glob.glob(pattern))
    ]
    logger.info("Read spectra from %d peak file(s)", len(input_filenames))
    if not input_filenames:
        raise ValueError("No input peak files found")
    if max_workers is None:
        max_workers = min(len(input_filenames), multiprocessing.cpu_count())
    # CPUs left idle by one-worker-per-file go to intra-file range
    # parallelism for large MGFs (threaded GIL-released native parses).
    range_budget = max(
        1, multiprocessing.cpu_count() // max(len(input_filenames), 1)
    )

    charges = set()
    low_quality_counter, n_spectra = 0, 0

    def consume(result):
        nonlocal low_quality_counter, n_spectra
        charge_keys, n_kept, lqc = result
        low_quality_counter += lqc
        n_spectra += n_kept
        for key in charge_keys:
            charges.add(None if key == "None" else int(key))

    if max_workers <= 1 or len(input_filenames) == 1:
        for idx, filename in enumerate(input_filenames):
            consume(ingest_file_to_store(
                filename, idx, store.root, process_kwargs,
                range_budget=range_budget,
            ))
    else:
        # spawn (not fork): the parent may hold a live GPU client.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(
            max_workers=max_workers, mp_context=ctx
        ) as pool:
            futures = [
                pool.submit(ingest_file_to_store, fn, idx, store.root,
                            process_kwargs, range_budget)
                for idx, fn in enumerate(input_filenames)
            ]
            for future in as_completed(futures):
                consume(future.result())

    logger.info(
        "Read %d spectra from %d peak files", n_spectra,
        len(input_filenames),
    )
    logger.info("Skipped %d low-quality spectra", low_quality_counter)
    charge_list = sorted(
        charges, key=lambda c: (c is None, c if c is not None else 0)
    )
    store.save_charges(charge_list)
    return charge_list
