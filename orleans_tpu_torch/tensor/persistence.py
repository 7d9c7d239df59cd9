"""Vector-grain persistence: the tensor-path storage bridge.

A copy of ``orleans_tpu/tensor/persistence.py``'s ``VectorStore`` and
``MemoryVectorStore``.  The tensor path moves thousands of rows per
operation (eviction sweeps, activation floods), so its bridge is a bulk,
synchronous contract the arena calls from inside a tick: read a batch of
rows at activation (reference: Catalog.SetupActivationState,
Catalog.cs:731), write a batch at eviction (WriteStateAsync), with
per-grain record granularity, so state written by the tensor path is
readable grain by grain.  The store works on host numpy arrays only.

The file-backed and storage-provider stores belong to the host-integration
slice of the port.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


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
