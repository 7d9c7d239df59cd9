"""Vector-grain persistence: the tensor-path storage bridge.

A copy of ``orleans_tpu/tensor/persistence.py``'s ``VectorStore``,
``MemoryVectorStore``, ``FileVectorStore`` and ``fsync_write``.  The tensor path moves thousands of rows per
operation (eviction sweeps, activation floods), so its bridge is a bulk,
synchronous contract the arena calls from inside a tick: read a batch of
rows at activation (reference: Catalog.SetupActivationState,
Catalog.cs:731), write a batch at eviction (WriteStateAsync), with
per-grain record granularity, so state written by the tensor path is
readable grain by grain.  The store works on host numpy arrays only.

``fsync_write`` is the crash-safe file replace every durable write of the
storage plane rides (``FileVectorStore`` records, the snapshot store's
blobs and manifest, ``tensor/checkpoint.py``).  The storage-provider
bridge belongs to the host-integration slice of the port.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional

import numpy as np


def fsync_write(path: str, writer, binary: bool = True) -> None:
    """Crash-safe file replace: write to a same-directory temp file, fsync
    the data, atomically rename over the destination, fsync the
    directory.  A kill at any byte offset leaves either the old file or
    the new one, never a torn final path.  ``writer`` receives the open
    temp file object."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
    try:
        with open(tmp, "wb" if binary else "w") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    # the rename itself must be durable: fsync the containing directory
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


class VectorStore:
    """Bulk per-row storage contract for vector-grain arenas.

    Rows are keyed by ``(type_name, primary_key_int)``; each record is a
    ``{field_name: np.ndarray}`` dict (one arena row).  All methods are
    synchronous: they run inside the tick machine.
    """

    def read_many(self, type_name: str, keys: Iterable[int]
                  ) -> Dict[int, Dict[str, np.ndarray]]:
        """Return stored rows for the subset of ``keys`` that exist."""
        raise NotImplementedError

    def write_many(self, type_name: str, keys: Iterable[int],
                   rows: List[Dict[str, np.ndarray]]) -> None:
        raise NotImplementedError

    def write_many_columnar(self, type_name: str, keys: List[int],
                            columns: Dict[str, np.ndarray]) -> None:
        """Columnar bulk write: ``columns[field][i]`` is row i's value for
        ``keys[i]`` (one gathered [n, ...] array per state field, the shape
        eviction produces).  Stores that can slice columns directly
        override this; the base adapts to ``write_many``."""
        n = len(keys)
        self.write_many(
            type_name, keys,
            [{name: col[i] for name, col in columns.items()}
             for i in range(n)])

    def delete_many(self, type_name: str, keys: Iterable[int]) -> None:
        raise NotImplementedError

    def list_keys(self, type_name: str) -> np.ndarray:
        """All stored keys for a type."""
        raise NotImplementedError


class MemoryVectorStore(VectorStore):
    """In-process store; pass a shared ``backing`` so several engines (or a
    restarted one) see the same rows."""

    def __init__(self, backing: Optional[Dict] = None) -> None:
        self._store: Dict[tuple, Dict[str, np.ndarray]] = \
            backing if backing is not None else {}

    @staticmethod
    def shared_backing() -> Dict:
        return {}

    def read_many(self, type_name, keys):
        out = {}
        for k in keys:
            row = self._store.get((type_name, int(k)))
            if row is not None:
                out[int(k)] = {n: v.copy() for n, v in row.items()}
        return out

    def write_many(self, type_name, keys, rows):
        for k, row in zip(keys, rows):
            self._store[(type_name, int(k))] = \
                {n: np.asarray(v).copy() for n, v in row.items()}

    def write_many_columnar(self, type_name, keys, columns):
        # slice the gathered columns directly: each record owns a copy of
        # its values without a per-row dict pass
        cols = {n: np.ascontiguousarray(c) for n, c in columns.items()}
        for i, k in enumerate(keys):
            self._store[(type_name, int(k))] = \
                {n: c[i].copy() for n, c in cols.items()}

    def delete_many(self, type_name, keys):
        for k in keys:
            self._store.pop((type_name, int(k)), None)

    def list_keys(self, type_name):
        return np.array(sorted(k for t, k in self._store if t == type_name),
                        dtype=np.int64)


class FileVectorStore(VectorStore):
    """One ``.npz`` per row under ``root/<type>/<key>.npz``: the simple
    durable backend (records survive the process).  Every record write
    rides ``fsync_write``, so a kill mid-write leaves the previous record
    intact and never a torn final path."""

    def __init__(self, root: str) -> None:
        self.root = root

    def _dir(self, type_name: str) -> str:
        d = os.path.join(self.root, type_name)
        os.makedirs(d, exist_ok=True)
        return d

    def read_many(self, type_name, keys):
        d = self._dir(type_name)
        out = {}
        for k in keys:
            path = os.path.join(d, f"{int(k)}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    out[int(k)] = {n: z[n] for n in z.files}
        return out

    def write_many(self, type_name, keys, rows):
        d = self._dir(type_name)
        for k, row in zip(keys, rows):
            fsync_write(
                os.path.join(d, f"{int(k)}.npz"),
                lambda f, row=row: np.savez(
                    f, **{n: np.asarray(v) for n, v in row.items()}))

    def write_many_columnar(self, type_name, keys, columns):
        d = self._dir(type_name)
        for i, k in enumerate(keys):
            fsync_write(
                os.path.join(d, f"{int(k)}.npz"),
                lambda f, i=i: np.savez(
                    f, **{n: c[i] for n, c in columns.items()}))

    def delete_many(self, type_name, keys):
        d = self._dir(type_name)
        for k in keys:
            try:
                os.remove(os.path.join(d, f"{int(k)}.npz"))
            except FileNotFoundError:
                pass

    def list_keys(self, type_name):
        d = self._dir(type_name)
        keys = [int(m.group(1)) for f in os.listdir(d)
                if (m := re.fullmatch(r"(-?\d+)\.npz", f))]
        return np.array(sorted(keys), dtype=np.int64)
