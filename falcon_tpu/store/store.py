"""On-disk columnar spectrum store.

First-party equivalent of the reference's per-charge Lance datasets
(``falcon/falcon.py:143-157, 331-359, 446-480``): preprocessed spectra are
appended in batches to per-charge datasets under ``work_dir/spectra/``,
then read back column-projected for clustering and randomly accessed
(``take``) for medoid export.

Layout::

    root/
      spectra_charge_2/
        shard_000000/
          identifier.npy      (unicode)
          filename.npy        (unicode)
          precursor_mz.npy    (float32)
          precursor_charge.npy(int16, NULL_CHARGE for None)
          retention_time.npy  (float32)
          peak_offsets.npy    (int64, n+1 ragged offsets)
          mz.npy              (float32, flat)
          intensity.npy       (float32, flat)
        shard_000001/ ...

Ragged peak arrays are stored flat + offsets so reads are zero-copy
(``np.load(mmap_mode='r')``) and convert directly to the padded
``(n, max_peaks)`` device layout used by the device kernels.
"""

import json
import logging
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("falcon_tpu")

NULL_CHARGE = np.int16(-(2**15))  # sentinel for a missing precursor charge

_COLUMNS = (
    "identifier",
    "filename",
    "precursor_mz",
    "precursor_charge",
    "retention_time",
)


def charge_key(charge: Optional[int]) -> str:
    """Dataset name component for a charge (None-charge spectra get their
    own bucket, mirroring reference ``falcon/falcon.py:432-434``)."""
    return "None" if charge is None else str(int(charge))


class ShardWriter:
    """Buffers processed-spectrum dicts per charge and writes shards.

    The reference buffers 10k rows per Lance append
    (``falcon/falcon.py:435``); we default to the same batch size.
    Thread-safe: a lock serializes shard-directory allocation per charge.
    """

    def __init__(self, root: str, batch_size: int = 10_000,
                 shard_prefix: str = ""):
        self.root = root
        self.batch_size = batch_size
        # A non-empty prefix gives this writer its own shard namespace so
        # multiple writer PROCESSES can append to the same dataset
        # without coordination (used by per-file ingest workers; prefixes
        # derive from the input file index, keeping runs deterministic).
        self.shard_prefix = shard_prefix
        self._shard_counts: Dict[str, int] = {}
        self._buffers: Dict[str, List[dict]] = {}
        # Columnar fast path: per-charge lists of column-dict chunks plus
        # buffered row counts (fed by ``add_batch``).
        self._col_buffers: Dict[str, List[Dict[str, np.ndarray]]] = {}
        self._col_counts: Dict[str, int] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._global_lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _charge_lock(self, key: str) -> threading.Lock:
        with self._global_lock:
            if key not in self._locks:
                self._locks[key] = threading.Lock()
            return self._locks[key]

    def add(self, spec: dict) -> None:
        key = charge_key(spec["precursor_charge"])
        lock = self._charge_lock(key)
        with lock:
            buf = self._buffers.setdefault(key, [])
            buf.append(spec)
            if len(buf) >= self.batch_size:
                self._flush_charge(key, buf)
                self._buffers[key] = []

    def add_many(self, specs: Iterable[dict]) -> None:
        for spec in specs:
            self.add(spec)

    def add_batch(self, batch: Dict[str, np.ndarray]) -> List[str]:
        """Append a columnar batch, partitioned by precursor charge.

        ``batch`` holds the columns produced by the native ingest fast
        path (``native.mgf_ingest`` plus a ``filename`` unicode column):
        ``identifier``/``filename`` (unicode), ``precursor_mz`` (f64),
        ``precursor_charge`` (int-like; ``NULL_CHARGE`` or the native
        int32 sentinel marks a missing charge), ``retention_time`` (f64),
        ``peak_offsets`` (i64, n+1), ``mz``/``intensity`` (f32 flat).

        Returns the charge keys seen in the batch.
        """
        offsets = np.asarray(batch["peak_offsets"], np.int64)
        n = len(offsets) - 1
        if n <= 0:
            return []
        lengths = np.diff(offsets)
        raw_charge = np.asarray(batch["precursor_charge"])
        null_mask = (raw_charge == -(2**31)) | (raw_charge == NULL_CHARGE)
        charge16 = np.where(null_mask, NULL_CHARGE, raw_charge).astype(
            np.int16
        )
        keys_seen = []
        for charge_val in np.unique(charge16):
            mask = charge16 == charge_val
            key = ("None" if charge_val == NULL_CHARGE
                   else str(int(charge_val)))
            keys_seen.append(key)
            flat_mask = np.repeat(mask, lengths)
            sub_lengths = lengths[mask]
            sub_offsets = np.zeros(len(sub_lengths) + 1, np.int64)
            np.cumsum(sub_lengths, out=sub_offsets[1:])
            chunk = {
                "identifier": np.asarray(batch["identifier"])[mask],
                "filename": np.asarray(batch["filename"])[mask],
                "precursor_mz": np.asarray(
                    batch["precursor_mz"], np.float32)[mask],
                "precursor_charge": charge16[mask],
                "retention_time": np.asarray(
                    batch["retention_time"], np.float32)[mask],
                "peak_offsets": sub_offsets,
                "mz": np.asarray(batch["mz"], np.float32)[flat_mask],
                "intensity": np.asarray(
                    batch["intensity"], np.float32)[flat_mask],
            }
            with self._charge_lock(key):
                chunks = self._col_buffers.setdefault(key, [])
                chunks.append(chunk)
                self._col_counts[key] = (
                    self._col_counts.get(key, 0) + int(mask.sum())
                )
                if self._col_counts[key] >= self.batch_size:
                    self._write_shard(key, _concat_chunks(chunks))
                    self._col_buffers[key] = []
                    self._col_counts[key] = 0
        return keys_seen

    def close(self) -> List[str]:
        """Flush all remaining buffers; returns the charge keys written.

        The buffer is re-read UNDER the charge lock (not snapshotted
        outside it): a concurrent ``add()`` may flush and replace the
        list between iteration and lock acquisition, and flushing a
        stale snapshot would write those rows to a second shard.
        """
        for key in list(self._buffers):
            with self._charge_lock(key):
                buf = self._buffers.get(key)
                if buf:
                    self._flush_charge(key, buf)
                    self._buffers[key] = []
        for key in list(self._col_buffers):
            with self._charge_lock(key):
                chunks = self._col_buffers.get(key)
                if chunks:
                    self._write_shard(key, _concat_chunks(chunks))
                    self._col_buffers[key] = []
                    self._col_counts[key] = 0
        return sorted(set(self._buffers) | set(self._col_buffers))

    def _flush_charge(self, key: str, rows: List[dict]) -> None:
        n = len(rows)
        lengths = np.array([len(r["mz"]) for r in rows], np.int64)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        columns = {
            "identifier": np.array([r["identifier"] for r in rows]),
            "filename": np.array([r["filename"] or "" for r in rows]),
            "precursor_mz": np.array(
                [r["precursor_mz"] for r in rows], np.float32),
            "precursor_charge": np.array(
                [NULL_CHARGE if r["precursor_charge"] is None
                 else r["precursor_charge"] for r in rows],
                np.int16,
            ),
            "retention_time": np.array(
                [r["retention_time"] for r in rows], np.float32),
            "peak_offsets": offsets,
            "mz": np.concatenate(
                [r["mz"] for r in rows]).astype(np.float32),
            "intensity": np.concatenate(
                [r["intensity"] for r in rows]).astype(np.float32),
        }
        self._write_shard(key, columns)

    def _write_shard(self, key: str, columns: Dict[str, np.ndarray]) -> None:
        dataset_dir = os.path.join(self.root, f"spectra_charge_{key}")
        os.makedirs(dataset_dir, exist_ok=True)
        if self.shard_prefix:
            seq = self._shard_counts.get(key, 0)
            self._shard_counts[key] = seq + 1
            name = f"shard_{self.shard_prefix}{seq:06d}"
        else:
            existing = [d for d in os.listdir(dataset_dir)
                        if d.startswith("shard_")]
            name = f"shard_{len(existing):06d}"
        shard_dir = os.path.join(dataset_dir, name)
        tmp_dir = shard_dir + ".tmp"
        os.makedirs(tmp_dir)
        for col, arr in columns.items():
            np.save(os.path.join(tmp_dir, f"{col}.npy"), arr)
        os.rename(tmp_dir, shard_dir)  # atomic publish


def _concat_chunks(
    chunks: List[Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """Concatenate columnar chunks, rebasing the ragged peak offsets."""
    if len(chunks) == 1:
        return chunks[0]
    out: Dict[str, np.ndarray] = {}
    for name in ("identifier", "filename", "precursor_mz",
                 "precursor_charge", "retention_time", "mz", "intensity"):
        out[name] = np.concatenate([c[name] for c in chunks])
    offsets = [np.zeros(1, np.int64)]
    base = 0
    for c in chunks:
        offsets.append(c["peak_offsets"][1:] + base)
        base += int(c["peak_offsets"][-1])
    out["peak_offsets"] = np.concatenate(offsets)
    return out


class ChargeDataset:
    """Read-only view over one per-charge dataset directory."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.isdir(path):
            raise ValueError(f"Non-existing dataset {path}")
        self.shards = sorted(
            os.path.join(path, d)
            for d in os.listdir(path)
            if d.startswith("shard_") and not d.endswith(".tmp")
        )

    def count_rows(self) -> int:
        total = 0
        for shard in self.shards:
            offsets = np.load(
                os.path.join(shard, "peak_offsets.npy"), mmap_mode="r"
            )
            total += len(offsets) - 1
        return total

    def validate(self) -> None:
        """Raise ValueError/OSError if any shard is structurally
        corrupt (missing/truncated/garbage columns, row counts
        disagreeing across columns, peak offsets inconsistent with the
        flat peak arrays).

        Cheap — header reads plus one offsets column per shard — and
        called when the CLI opens a resumed dataset, so a charge whose
        persisted store was damaged is DROPPED with an error like the
        reference dropping an unopenable Lance dataset
        (``falcon/falcon.py:315-322``), instead of crashing mid-run on
        a lazy load.
        """
        for shard in self.shards:
            try:
                self._validate_shard(shard)
            except (ValueError, OSError, MemoryError):
                # MemoryError is host pressure, not shard corruption —
                # folding it into the ValueError below would make the
                # caller's drop-the-charge net silently discard a
                # healthy charge.
                raise
            except Exception as exc:
                # Garbage content can fail in arbitrary ways before the
                # structural checks run (0-d arrays break len(),
                # string dtypes break np.diff, non-numeric offsets
                # break int(), ...); fold every such failure into the
                # documented ValueError contract so the caller's
                # drop-the-charge net catches it.
                raise ValueError(
                    f"Corrupt store shard {shard}: {exc}") from exc

    def _validate_shard(self, shard: str) -> None:
        offsets = np.asarray(self._load(shard, "peak_offsets"))
        n = len(offsets) - 1
        if n < 0 or offsets[0] != 0 or (np.diff(offsets) < 0).any():
            raise ValueError(
                f"Corrupt peak offsets in store shard {shard}")
        for col in _COLUMNS:
            if len(self._load(shard, col)) != n:
                raise ValueError(
                    f"Column {col} row count mismatch in store "
                    f"shard {shard}")
        n_peaks = int(offsets[-1])
        for col in ("mz", "intensity"):
            if len(self._load(shard, col)) != n_peaks:
                raise ValueError(
                    f"Peak array {col} length mismatch in store "
                    f"shard {shard}")

    def _load(self, shard: str, column: str, mmap: bool = True) -> np.ndarray:
        return np.load(
            os.path.join(shard, f"{column}.npy"),
            mmap_mode="r" if mmap else None,
            allow_pickle=False,
        )

    def read_metadata(
        self, columns: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        """Scalar columns concatenated across shards.

        ``columns`` projects the read (like the reference's Lance
        ``to_table(columns=...)``, ``falcon/falcon.py:162-170``): the
        engines only need the float columns — loading the identifier/
        filename unicode columns for a 12.5M-row charge costs ~3 GB of
        transient host memory they never use.
        """
        cols = tuple(columns) if columns is not None else _COLUMNS
        out: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
        for shard in self.shards:
            for c in cols:
                out[c].append(np.asarray(self._load(shard, c, mmap=False)))
        return {c: np.concatenate(v) if v else np.empty(0)
                for c, v in out.items()}

    def read_peaks(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets, mz_flat, intensity_flat) concatenated across shards."""
        all_offsets, all_mz, all_int = [np.zeros(1, np.int64)], [], []
        base = 0
        for shard in self.shards:
            offsets = np.asarray(self._load(shard, "peak_offsets"))
            all_offsets.append(offsets[1:] + base)
            base += offsets[-1]
            all_mz.append(np.asarray(self._load(shard, "mz")))
            all_int.append(np.asarray(self._load(shard, "intensity")))
        return (
            np.concatenate(all_offsets),
            np.concatenate(all_mz) if all_mz else np.empty(0, np.float32),
            np.concatenate(all_int) if all_int else np.empty(0, np.float32),
        )

    def take(self, indices: Sequence[int]) -> List[dict]:
        """Random access by global row index (reference
        ``falcon/falcon.py:200`` uses ``dataset.take(medoids)``)."""
        indices = np.asarray(indices, np.int64)
        # Build shard spans.
        spans = []
        start = 0
        for shard in self.shards:
            offsets = self._load(shard, "peak_offsets")
            n = len(offsets) - 1
            spans.append((start, start + n, shard))
            start += n
        rows: List[Optional[dict]] = [None] * len(indices)
        order = np.argsort(indices, kind="stable")
        si = 0
        cache: Dict[str, dict] = {}
        for pos in order:
            idx = indices[pos]
            while si < len(spans) and idx >= spans[si][1]:
                si += 1
            if si == len(spans) or idx < spans[si][0]:
                # Restart scan (indices not monotone within shards).
                si = next(
                    (i for i, (lo, hi, _) in enumerate(spans)
                     if lo <= idx < hi), None,
                )
                if si is None:
                    raise IndexError(
                        f"row index {int(idx)} out of range for dataset "
                        f"with {spans[-1][1] if spans else 0} rows"
                    )
            lo, _, shard = spans[si]
            if shard not in cache:
                cache[shard] = {
                    c: self._load(shard, c, mmap=False) for c in _COLUMNS
                }
                cache[shard]["peak_offsets"] = self._load(
                    shard, "peak_offsets"
                )
                cache[shard]["mz"] = self._load(shard, "mz")
                cache[shard]["intensity"] = self._load(shard, "intensity")
            cols = cache[shard]
            local = int(idx - lo)
            o0, o1 = cols["peak_offsets"][local], cols["peak_offsets"][local + 1]
            charge = int(cols["precursor_charge"][local])
            rows[pos] = {
                "identifier": str(cols["identifier"][local]),
                "filename": str(cols["filename"][local]),
                "precursor_mz": float(cols["precursor_mz"][local]),
                "precursor_charge": None if charge == NULL_CHARGE else charge,
                "retention_time": float(cols["retention_time"][local]),
                "mz": np.asarray(cols["mz"][o0:o1], np.float32),
                "intensity": np.asarray(cols["intensity"][o0:o1], np.float32),
            }
        return rows


class SpectrumStore:
    """The ``work_dir/spectra`` root: per-charge datasets + charge cache.

    The charge-set cache mirrors the reference's ``charges.joblib`` resume
    point (``falcon/falcon.py:143-149``): if it exists and ``overwrite`` is
    not set, ingest is skipped entirely.
    """

    CHARGES_FILE = "charges.json"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    @property
    def charges_path(self) -> str:
        return os.path.join(self.root, self.CHARGES_FILE)

    def load_charges(self) -> Optional[List[Optional[int]]]:
        """The persisted charge set, or None when the cache is absent OR
        unreadable — a corrupt/truncated cache means the previous run's
        commit record cannot be trusted, which is the same situation as
        a run that died before writing it (the caller discards the
        partial store and re-ingests, falcon_tpu/cli.py)."""
        if not os.path.isfile(self.charges_path):
            return None
        try:
            with open(self.charges_path) as f:
                return [None if c is None else int(c)
                        for c in json.load(f)]
        except (ValueError, TypeError, UnicodeDecodeError, OSError) as exc:
            # TypeError covers a cache that is valid JSON but not a
            # list of charges (e.g. a bare scalar) — same distrust as
            # undecodable bytes.
            logger.warning(
                "Unreadable charge cache %s (%s); treating the work "
                "directory as an incomplete ingest",
                self.charges_path, exc,
            )
            return None

    def save_charges(self, charges: Iterable[Optional[int]]) -> None:
        with open(self.charges_path, "w") as f:
            json.dump(list(charges), f)

    def dataset(self, charge: Optional[int]) -> ChargeDataset:
        return ChargeDataset(
            os.path.join(self.root, f"spectra_charge_{charge_key(charge)}")
        )

    def writer(self, batch_size: int = 10_000,
               shard_prefix: str = "") -> ShardWriter:
        return ShardWriter(self.root, batch_size, shard_prefix)

    def clear(self) -> None:
        """Remove all datasets (reference ``falcon/falcon.py:139-141``)."""
        import shutil

        for entry in os.listdir(self.root):
            path = os.path.join(self.root, entry)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)


def padded_peaks(
    offsets: np.ndarray,
    mz_flat: np.ndarray,
    intensity_flat: np.ndarray,
    max_peaks: int,
    row_indices: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert ragged peaks to the padded device layout.

    Returns ``(mz, intensity, n_peaks)`` with shapes ``(n, max_peaks)``,
    ``(n, max_peaks)``, ``(n,)``.  Padding uses m/z = -1e6 (far outside any
    fragment tolerance window) and intensity = 0 so padded entries can never
    match, and never contribute to scores.
    """
    if row_indices is None:
        row_indices = np.arange(len(offsets) - 1)
    row_indices = np.asarray(row_indices, np.int64)
    n = len(row_indices)
    starts = offsets[row_indices]
    lengths = (offsets[row_indices + 1] - starts).astype(np.int64)
    max_len = int(lengths.max(initial=0))
    if max_len > max_peaks:
        raise ValueError(
            f"spectrum with {max_len} peaks exceeds max_peaks={max_peaks}"
        )
    mz = np.full((n, max_peaks), -1e6, np.float32)
    intensity = np.zeros((n, max_peaks), np.float32)
    col = np.arange(max_peaks)[None, :]
    valid = col < lengths[:, None]
    flat_idx = (starts[:, None] + col)[valid]
    mz[valid] = mz_flat[flat_idx]
    intensity[valid] = intensity_flat[flat_idx]
    return mz, intensity, lengths
