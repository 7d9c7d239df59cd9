"""GrainArena: the stacked state store for one vector grain type.

The port of ``orleans_tpu/tensor/arena.py``, main-path subset.  The arena
is the tensor-path Catalog + ActivationDirectory (reference: Catalog.cs:43,
ActivationDirectory.cs:33): an activation is a *row*; the host keeps the
key→row index (the local directory partition) and the device holds the
state columns plus a mirror of the index, so emitted messages resolve
their destination rows without a host round trip.

Auto-activation: resolving an unseen key allocates a row and initialises
its columns from the declared field inits — the batched analog of
GetOrCreateActivation (reference: Catalog.cs:411).

One card holds one shard block, so rows are allocated by a bump pointer
over ``[0, capacity)`` and growth doubles the block in place (rows keep
their index; the generation still bumps, as in the JAX package).

Keys span ``[0, 2**63)``.  Keys that fit int32 resolve on the device
through the dense or the sorted mirror; an arena holding a wider key
resolves through the two-level wide mirror (``device_index_wide``): wide
keys ride as ``(hi, lo)`` int32 word pairs, hashed into 30-bit buckets
and checked against the full words (reference key breadth:
UniqueKey.cs:34).  Eviction, replicas, migration, resharding and the
checkpoint layout belong to later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.vector_grain import StateField, VectorGrainInfo


class ArenaFullError(RuntimeError):
    pass


# -- wide (64-bit) keys ------------------------------------------------------
# copies of orleans_tpu/tensor/arena.py's helpers: a wide key rides the
# device as two int32 words, and routing hashes the words into a 30-bit
# bucket space (the int32 padding sentinel then never equals a hash)

def split_wide_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64[n] → (hi int32[n], lo int32[n]) bit-pattern words."""
    u = np.asarray(keys).astype(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def join_wide_keys(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 words → int64 keys (bit-pattern inverse)."""
    u = (np.asarray(hi).view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo).view(np.uint32).astype(np.uint64)
    return u.astype(np.int64)


def mix32_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """30-bit bucket hash of a wide key's words; bit-identical to the
    device hash (``kernels.resolve.mix32`` and ``csrc/resolve_wide.cu``)."""
    h = (np.asarray(hi).view(np.uint32) * np.uint32(0x85EBCA6B)) \
        ^ (np.asarray(lo).view(np.uint32) * np.uint32(0xC2B2AE35))
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x27D4EB2F)
    h = h ^ (h >> np.uint32(13))
    return (h & np.uint32(0x3FFFFFFF)).astype(np.int32)


class GrainArena:

    # dense direct-map mirror: for small integer key spaces the directory
    # collapses from a binary search to one gather, worth 4 bytes per
    # key-space slot while the largest key stays within this bound
    DENSE_KEY_BOUND = 1 << 23  # 8M slots = 32 MB ceiling

    def __init__(self, info: VectorGrainInfo, device: torch.device,
                 capacity: int = 1024) -> None:
        self.info = info
        self.device = device
        self.capacity = max(1, capacity)
        self.state: Dict[str, torch.Tensor] = {}
        self._init_state_columns(self.capacity)
        # bumped whenever the capacity (and so every column) changes;
        # consumers holding resolved row vectors re-resolve on mismatch
        self.generation = 0
        # host-side directory partition: key → row
        self._key_of_row = np.full(self.capacity, -1, dtype=np.int64)
        self._next_row = 0
        self._sorted_keys = np.empty(0, dtype=np.int64)
        self._sorted_rows = np.empty(0, dtype=np.int32)
        self._dirty = False
        self.live_count = 0
        # eviction (free-list deactivation) belongs to a later slice of
        # the port: the epoch it bumps stays 0, and the fused window and
        # the auto-fuser check it as the JAX package does
        self.eviction_epoch = 0
        # host-side last use: updated by host-key resolution
        self.last_use_tick = np.zeros(self.capacity, dtype=np.int64)
        # end tick of the latest fused window over this arena: every row
        # live then was used then (see ``last_use``), stamped in O(1)
        self.fused_use_tick = 0
        # weakref to the owning engine: row moves settle its auto-fusion
        # chain first (``_settle_owner_chain``)
        self._owner_engine: Optional[Any] = None
        # device-side last use: a scatter-max by the engine for
        # device-routed batches, which never cross to the host (int32, as
        # in the JAX package: a tick counter)
        self.last_use_dev = torch.zeros(self.capacity, dtype=torch.int32,
                                        device=device)
        # device-side directory mirrors (int32 keys only)
        self._dev_sorted_keys: Optional[torch.Tensor] = None
        self._dev_sorted_rows: Optional[torch.Tensor] = None
        self._dev_dense: Optional[torch.Tensor] = None
        self._dev_index_stale = True
        self._dev_dense_stale = True
        # the wide-key (two-level hash/bucket) mirror, built on demand
        self._dev_wide: Optional[Tuple[torch.Tensor, ...]] = None
        self._dev_wide_stale = True
        # True once an activated key does not fit the int32 device keys:
        # narrow emits to this arena then resolve through the wide mirror
        self.has_wide_keys = False

    def _settle_owner_chain(self) -> None:
        """Rows are about to move (growth): settle the owning engine's
        auto-fusion verification chain FIRST, while its pre-move state
        pin is still restorable — the chain verifies exact, or rolls back
        and replays now, against the current layout."""
        ref = self._owner_engine
        engine = ref() if ref is not None else None
        if engine is not None and engine.autofuser._unverified:
            engine.autofuser._settle_chain()

    def _attribution(self):
        """The owning engine's workload-attribution plane when it holds
        counts for this arena: a row move must move them too."""
        ref = self._owner_engine
        engine = ref() if ref is not None else None
        att = getattr(engine, "attribution", None) \
            if engine is not None else None
        return att if att is not None and att.has_state(self.info.name) \
            else None

    def last_use(self, rows: np.ndarray) -> np.ndarray:
        """Host last-use tick of live ``rows``: the later of the host
        stamp and the latest fused window (which counts every live row
        as used; no eviction frees rows in this slice)."""
        return np.maximum(self.last_use_tick[rows], self.fused_use_tick)

    # -- state columns ------------------------------------------------------

    def _make_column(self, f: StateField, capacity: int) -> torch.Tensor:
        return torch.full((capacity, *f.shape), f.init, dtype=f.dtype,
                          device=self.device)

    def _init_state_columns(self, capacity: int) -> None:
        self.state = {name: self._make_column(f, capacity)
                      for name, f in self.info.state_fields.items()}

    def touch_rows_dev(self, rows: torch.Tensor, tick: int) -> None:
        """Record device-routed traffic for collection (scatter-max in
        place, stays on the device; padding rows -1 dropped)."""
        row_scatter(self.last_use_dev, rows, int(tick), "max")

    def adopt_state(self, new_state: Dict[str, Any]) -> None:
        """Make a step's output columns the live state, after checking
        that no column went missing or changed shape, dtype or device
        (every cached row vector and directory mirror assumes them)."""
        if new_state is self.state:
            return
        for name, col in self.state.items():
            new = new_state.get(name)
            if new is None:
                raise ValueError(
                    f"adopt_state({self.info.name}): step output dropped "
                    f"column {name!r}")
            if new.shape != col.shape or new.dtype != col.dtype \
                    or new.device != col.device:
                raise ValueError(
                    f"adopt_state({self.info.name}.{name}): output "
                    f"{tuple(new.shape)}/{new.dtype}/{new.device} != live "
                    f"{tuple(col.shape)}/{col.dtype}/{col.device}")
        self.state = new_state

    # -- key → row resolution ----------------------------------------------

    def _rebuild_index(self) -> None:
        rows = np.nonzero(self._key_of_row >= 0)[0].astype(np.int32)
        keys = self._key_of_row[rows]
        order = np.argsort(keys, kind="stable")
        self._sorted_keys = keys[order]
        self._sorted_rows = rows[order]
        self._dirty = False
        self._dev_index_stale = True
        self._dev_dense_stale = True
        self._dev_wide_stale = True

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def device_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The key→row map as device tensors: sorted int32 keys and their
        rows, padded to capacity with the key sentinel (and row -1) so the
        shapes change only when the arena grows."""
        if self._dirty:
            self._rebuild_index()
        if self._dev_index_stale or self._dev_sorted_keys is None:
            keys32 = self._sorted_keys.astype(np.int32)
            if np.any(keys32.astype(np.int64) != self._sorted_keys):
                raise OverflowError(
                    f"arena {self.info.name}: keys exceed int32; device "
                    f"routing unavailable (use host-side resolution)")
            pad = self.capacity - len(keys32)
            keys_padded = np.concatenate(
                [keys32, np.full(pad, KEY_SENTINEL, np.int32)])
            rows_padded = np.concatenate(
                [self._sorted_rows, np.full(pad, -1, np.int32)])
            self._dev_sorted_keys = self._to_device(keys_padded)
            self._dev_sorted_rows = self._to_device(rows_padded)
            self._dev_index_stale = False
        return self._dev_sorted_keys, self._dev_sorted_rows

    def dense_index(self) -> Optional[torch.Tensor]:
        """key→row as a dense device tensor (``rows[key] == -1`` for
        unseen keys), or None when the key space is empty, too wide or
        too sparse to afford it."""
        if self._dirty:
            self._rebuild_index()
        if len(self._sorted_keys) == 0:
            return None
        max_key = int(self._sorted_keys[-1])
        if int(self._sorted_keys[0]) < 0 or max_key >= self.DENSE_KEY_BOUND:
            return None
        size = max_key + 1
        # sparsity guard: a handful of grains with one huge key must not
        # buy a multi-MB rebuild per activation
        if size > max(4 * max(1, self.live_count), 65536):
            return None
        if not self._dev_dense_stale and self._dev_dense is not None \
                and self._dev_dense.shape[0] >= size:
            return self._dev_dense
        # pad to the next power of two so growth rebuilds rarely
        alloc = 1 << (size - 1).bit_length()
        dense = np.full(alloc, -1, dtype=np.int32)
        dense[self._sorted_keys] = self._sorted_rows
        self._dev_dense = self._to_device(dense)
        self._dev_dense_stale = False
        return self._dev_dense

    def device_index_wide(self) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
        """The wide-key mirror ``(sorted_h, rows_by_h, hi_col, lo_col)``:
        the 30-bit hashes of the live keys in ascending order (ties in key
        order) padded to capacity with 2**31 - 1, the row of each (padded
        with -1), and the two words of the key of every row (0 and -1 on
        free rows).  Rebuilt after any activation or growth."""
        if self._dirty:
            self._rebuild_index()
        if self._dev_wide_stale or self._dev_wide is None:
            hi, lo = split_wide_keys(self._sorted_keys)
            h = mix32_np(hi, lo)
            order = np.argsort(h, kind="stable")
            pad = self.capacity - len(h)
            sorted_h = np.concatenate(
                [h[order], np.full(pad, 2**31 - 1, np.int32)])
            rows_by_h = np.concatenate(
                [self._sorted_rows[order], np.full(pad, -1, np.int32)])
            hi_col = np.zeros(self.capacity, np.int32)
            lo_col = np.full(self.capacity, -1, np.int32)
            hi_col[self._sorted_rows] = hi
            lo_col[self._sorted_rows] = lo
            self._dev_wide = tuple(self._to_device(p) for p in
                                   (sorted_h, rows_by_h, hi_col, lo_col))
            self._dev_wide_stale = False
        return self._dev_wide

    def lookup_rows(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized lookup; returns (rows int32, found bool)."""
        if self._dirty:
            self._rebuild_index()
        if len(self._sorted_keys) == 0:
            return (np.full(len(keys), -1, np.int32),
                    np.zeros(len(keys), bool))
        idx = np.searchsorted(self._sorted_keys, keys)
        idx = np.minimum(idx, len(self._sorted_keys) - 1)
        found = self._sorted_keys[idx] == keys
        rows = np.where(found, self._sorted_rows[idx], -1).astype(np.int32)
        return rows, found

    def resolve_rows(self, keys: np.ndarray, auto_activate: bool = True,
                     tick: int = 0) -> np.ndarray:
        """key→row with auto-activation of unseen keys
        (batched GetOrCreateActivation)."""
        keys = np.asarray(keys, dtype=np.int64)
        rows, found = self.lookup_rows(keys)
        if auto_activate and not found.all():
            missing = np.unique(keys[~found])
            self._activate_keys(missing)
            rows, found = self.lookup_rows(keys)
            if not found.all():
                raise ArenaFullError(
                    f"arena {self.info.name}: activation failed for "
                    f"{(~found).sum()} keys")
        self.last_use_tick[rows[rows >= 0]] = tick
        return rows

    def _take_rows(self, n: int) -> np.ndarray:
        """Allocate ``n`` fresh rows from the bump pointer without binding
        keys.  Callers guarantee capacity."""
        rows = np.arange(self._next_row, self._next_row + n, dtype=np.int64)
        self._next_row += n
        return rows

    def _ensure_capacity(self, need: int) -> None:
        """Grow until ``need`` more rows fit."""
        while self._next_row + need > self.capacity:
            self._grow()

    def _activate_keys(self, keys: np.ndarray) -> None:
        if len(keys) and int(keys.min()) < 0:
            # the row map's free-slot sentinel is -1: the grain key
            # domain is [0, 2**63)
            raise ValueError(
                f"arena {self.info.name}: grain keys must be in "
                f"[0, 2**63); got {int(keys.min())}")
        if len(keys) and int(keys.max()) >= KEY_SENTINEL:
            self.has_wide_keys = True
        self._ensure_capacity(len(keys))
        rows = self._take_rows(len(keys))
        self._key_of_row[rows] = keys
        self.live_count += len(keys)
        self._dirty = True

    # -- growth -------------------------------------------------------------

    def _grow(self) -> None:
        """Double the capacity.  With one shard block every row keeps its
        index, so the old columns copy into the front of the new ones;
        the generation bumps because every column tensor is new."""
        self._settle_owner_chain()
        old = self.capacity
        new_capacity = old * 2
        new_state: Dict[str, torch.Tensor] = {}
        for name, f in self.info.state_fields.items():
            col = self._make_column(f, new_capacity)
            col[:old] = self.state[name]
            new_state[name] = col
        last_use = torch.zeros(new_capacity, dtype=torch.int32,
                               device=self.device)
        last_use[:old] = self.last_use_dev
        key_of_row = np.full(new_capacity, -1, dtype=np.int64)
        key_of_row[:old] = self._key_of_row
        last_use_tick = np.zeros(new_capacity, dtype=np.int64)
        last_use_tick[:old] = self.last_use_tick
        att = self._attribution()
        if att is not None:
            # traffic counts move with their rows (which keep their index)
            live = np.nonzero(self._key_of_row >= 0)[0]
            att.remap_rows(self, live, live, new_capacity)

        self.state = new_state
        self.last_use_dev = last_use
        self.capacity = new_capacity
        self._key_of_row = key_of_row
        self.last_use_tick = last_use_tick
        self._dirty = True
        self.generation += 1

    def reserve(self, n: int) -> None:
        """Pre-size so ~n activations fit without growth mid-run."""
        while self.capacity < n * 2:
            self._grow()

    # -- host access --------------------------------------------------------

    def read_row(self, key: int) -> Optional[Dict[str, np.ndarray]]:
        rows, found = self.lookup_rows(np.array([key], dtype=np.int64))
        if not found[0]:
            return None
        r = int(rows[0])
        return {name: col[r].cpu().numpy() for name, col in self.state.items()}

    def keys(self) -> np.ndarray:
        return self._key_of_row[self._key_of_row >= 0]
