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

Shard blocks: an arena of ``n_shards`` blocks (the engine's ``ShardMesh``,
``tensor/mesh.py``, or a mesh-less ``engine.n_shards``) splits its rows
into equal blocks, block ``s`` being ``[s * shard_capacity, (s + 1) *
shard_capacity)``.  A key activates in its home block (``home_shards``:
``shard_of_keys`` unless a live-migration pin says otherwise), its row
coming from that block's LIFO free list first, then from the block's bump
pointer, in the JAX package's order, so the rows equal the JAX arena's
row for row.  Growth doubles every block: at one block in place (rows
keep their index), with several each row keeps its offset in its block.
The generation bumps either way, as in the JAX package.

Collection (reference: ActivationCollector.cs:37, Catalog.cs:836): the
victims of an idle sweep are selected on the device (K12, only the bool
mask crosses to the host), their state columns are gathered (K13) and
written back to the attached ``VectorStore`` before their rows are freed,
and the freed rows return to the free list scrubbed in place (K3 SET), so
the generation stands and only ``eviction_epoch`` bumps.  Past the
fragmentation threshold the block repacks (``_compact``: rows move, the
generation bumps).  A later activation of an evicted key reads its row
back from the store (reference: Catalog.SetupActivationState :731).
Before freed rows return to the free list, the owning engine's
attribution plane and stream routes retire them (``on_evict``), so a
reused row inherits neither traffic counts nor subscriptions.

Keys span ``[0, 2**63)``.  Keys that fit int32 resolve on the device
through the dense or the sorted mirror; an arena holding a wider key
resolves through the two-level wide mirror (``device_index_wide``): wide
keys ride as ``(hi, lo)`` int32 word pairs, hashed into 30-bit buckets
and checked against the full words (reference key breadth:
UniqueKey.cs:34).

Hot-grain replicas (``promote_replicas``): a grain whose handlers are
commutative can take k rows of the block, its PRIMARY (the row the
directory resolves to) and k - 1 secondaries that carry its key but stay
out of the directory index, ``keys()`` and ``live_count``.  Delivery
spreads each lane aimed at a primary over the group by lane hash (K18 on
the device, ``spread_rows_host`` on the host, against one mirror), so
one hot row's same-address updates split over k rows; reads fold the
group (sum: Σ − (k − 1)·init; max, min), and ``demote_replicas`` writes
the fold back to the primary and frees the secondaries.

The durable state plane (``tensor/checkpoint.py``) reads and writes the
arena's layout: ``export_layout`` copies a cut's identity metadata (the
key→row map, the bump pointer, generation, eviction epoch, the host use
clock, the replica groups), and ``adopt_layout`` / ``adopt_columns`` /
``adopt_delta`` / ``scatter_restore`` land a recovery point exactly, the
format the JAX package writes.  Adoption replaces the state tensors or the
row map while it may restore the recorded generation, so it bumps
``restore_epoch``, the signal a fused window rebuilds on (cause
``restore``).  ``checkpoint`` / ``restore_from_store`` are the per-grain
``VectorStore`` write of every live row and its reload.

Live migration (``migrate_keys``) moves grains between blocks with one
K13 gather and one K3 SET per column, pins each move in
``_shard_override`` and bumps the eviction epoch.  Resharding, and
recovery points of several blocks or with pins, belong to the next slice
of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.device import fetch_host, host_upload
from orleans_tpu_torch.kernels.lifecycle import gather_rows, idle_mask
from orleans_tpu_torch.kernels.pull import touch_dense
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.vector_grain import StateField, VectorGrainInfo


class ArenaFullError(RuntimeError):
    pass


_RESHARD = ("belongs to the next slice of the port (reshard, and recovery "
            "points of several shard blocks or with migration pins; "
            "ROADMAP queue A, item 7)")


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (the store's arrays)."""
    return torch.empty((), dtype=dtype).numpy().dtype


# -- wide (64-bit) keys ------------------------------------------------------
# copies of orleans_tpu/tensor/arena.py's helpers: a wide key rides the
# device as two int32 words, and routing hashes the words into a 30-bit
# bucket space (the int32 padding sentinel then never equals a hash)

def _hash_keys_u64(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (``hashing.stable_hash_u64``), the JAX
    arena's helper, so both packages put a key on the same shard."""
    x = keys.astype(np.uint64)
    x = x + np.uint64(0x9E3779B97F4A7C15)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def shard_of_keys(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """The device-shard-of-key function (``orleans_tpu/tensor/arena.py``'s
    ``shard_of_keys``): the stable key hash mod the shard count — the
    mesh-granularity twin of the silo ring's owner lookup
    (``runtime/ring.py`` re-exports it as ``device_shard_of_keys``)."""
    return (_hash_keys_u64(np.asarray(keys, dtype=np.int64))
            % np.uint64(max(1, n_shards))).astype(np.int64)


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
                 capacity: int = 1024, store: Optional[Any] = None,
                 n_shards: int = 1, sharding: Optional[Any] = None) -> None:
        self.info = info
        self.device = device
        # VectorStore (tensor/persistence.py): activation reads persisted
        # rows, eviction writes them back
        self.store = store
        self.evicted_count = 0
        self.restored_count = 0
        self.migrated_count = 0
        # shard blocks: block s is rows [s * shard_capacity, (s + 1) *
        # shard_capacity); the capacity divides evenly into them
        self.n_shards = max(1, int(n_shards))
        self.shard_capacity = max(1, -(-capacity // self.n_shards))
        self.capacity = self.shard_capacity * self.n_shards
        # the engine's BlockSharding marker when it has a mesh (None for
        # a mesh-less arena, whose batches never exchange)
        self.sharding = sharding
        self.state: Dict[str, torch.Tensor] = {}
        self._init_state_columns(self.capacity)
        # bumped whenever the capacity (and so every column) changes;
        # consumers holding resolved row vectors re-resolve on mismatch
        self.generation = 0
        # host-side directory partition: key → row
        self._key_of_row = np.full(self.capacity, -1, dtype=np.int64)
        # each shard block's bump pointer (rows used past its base) and
        # LIFO free list.  Free slots hold init-valued columns and zeroed
        # use clocks, so reuse needs no scrub.
        self._shard_next = np.zeros(self.n_shards, dtype=np.int64)
        self._free: list = [np.empty(0, dtype=np.int64)
                            for _ in range(self.n_shards)]
        # live-migration pins (key → block): keys ``migrate_keys`` moved
        # off their hash block; an evict → reactivate cycle returns such
        # a grain to its pinned block.  The sorted mirror serves
        # ``home_shards``' vectorized lookup (None = rebuild at next use).
        self._shard_override: Dict[int, int] = {}
        self._override_sorted: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # freed/high-water ratio above which deactivation repacks
        # (engine.arena_for sets it from TensorEngineConfig)
        self.compact_fragmentation = 0.75
        self._sorted_keys = np.empty(0, dtype=np.int64)
        self._sorted_rows = np.empty(0, dtype=np.int32)
        self._dirty = False
        self.live_count = 0
        # bumped whenever rows are freed without moving: holders of
        # resolved rows re-check liveness (generation = rows moved)
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
        # hot-grain replicas: key → int64 rows, rows[0] the PRIMARY (the
        # row the directory resolves to), rows[1:] the secondaries, which
        # carry the key in ``_key_of_row`` but stay out of the directory
        # index (``_replica_secondary``), so key → row stays a bijection
        # onto primaries and the spread is an explicit remap after it
        self._replicas: Dict[int, np.ndarray] = {}
        self._replica_secondary = np.zeros(self.capacity, dtype=bool)
        self.replica_promotions = 0
        self.replica_demotions = 0
        self.replica_folds = 0
        # device mirror of the spread map (K18's prim, counts, table),
        # cached until a promote, a demote or a row move stales it
        self._dev_replicas: Optional[Tuple[torch.Tensor, ...]] = None
        self._dev_replicas_stale = True
        # bumped whenever a recovery point's adoption replaces the state
        # tensors or the row map (the generation may come back equal)
        self.restore_epoch = 0

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

    def _stream_routes(self) -> list:
        """The owning engine's stream-subscription routes whose
        subscribers live in this arena (``tensor/streams_plane.py``)."""
        ref = self._owner_engine
        engine = ref() if ref is not None else None
        if engine is None:
            return []
        return [r for r in engine._stream_routes.values()
                if r.type_name == self.info.name]

    def last_use(self, rows) -> np.ndarray:
        """Host last-use tick of live ``rows``: the later of the host
        stamp and the end of the latest fused window, which counts every
        row live then as used (the JAX window stamps each live row).  A
        row activated since holds a later stamp of its own."""
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

    def touch_rows_dense(self, segments: torch.Tensor, tick: int) -> None:
        """A pull-mode delivery's touch: its row-aligned offsets know which
        rows received, so one elementwise pass (K17) stamps them — no
        lane-sized scatter."""
        touch_dense(self.last_use_dev, segments, int(tick))

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
        # replica secondaries stay out: the index is a bijection onto
        # primaries, and delivery reaches the group through the spread
        live = self._key_of_row >= 0
        if self._replicas:
            live &= ~self._replica_secondary
        rows = np.nonzero(live)[0].astype(np.int32)
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
        free rows).  The two word columns are the halves of one ``[capacity,
        2]`` array (views of stride 2), so K10 checks a candidate row with
        one 8-byte load.  Rebuilt after any activation or growth."""
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
            words = np.empty((self.capacity, 2), np.int32)
            words[:, 0], words[:, 1] = 0, -1
            words[self._sorted_rows, 0] = hi
            words[self._sorted_rows, 1] = lo
            words_d = self._to_device(words)
            self._dev_wide = (self._to_device(sorted_h),
                              self._to_device(rows_by_h), words_d[:, 0],
                              words_d[:, 1])
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

    def home_shards(self, keys: np.ndarray) -> np.ndarray:
        """The shard block each key activates in: its stable hash mod the
        block count, overridden by any live-migration pin (one
        searchsorted over the sorted pin mirror, cached until the pins
        change)."""
        if self.n_shards == 1:
            return np.zeros(len(keys), dtype=np.int64)
        shards = shard_of_keys(keys, self.n_shards)
        if self._shard_override:
            if self._override_sorted is None:
                ok = np.fromiter(self._shard_override.keys(), np.int64,
                                 len(self._shard_override))
                ov = np.fromiter(self._shard_override.values(), np.int64,
                                 len(self._shard_override))
                order = np.argsort(ok)
                self._override_sorted = (ok[order], ov[order])
            ok, ov = self._override_sorted
            idx = np.minimum(np.searchsorted(ok, keys), len(ok) - 1)
            hit = ok[idx] == keys
            shards[hit] = ov[idx[hit]]
        return shards

    def _take_rows(self, shards: np.ndarray) -> np.ndarray:
        """Allocate one row per entry of ``shards`` in that block without
        binding keys: free-list reuse first (the most recently freed
        slots, the tail of the block's list in its order), then the
        block's bump pointer.  Shared with ``migrate_keys``, which copies
        state into the rows before the key map flips.  Callers guarantee
        capacity."""
        shards = np.asarray(shards, dtype=np.int64)
        rows = np.empty(len(shards), dtype=np.int64)
        for s in np.unique(shards).tolist():
            sel = np.nonzero(shards == s)[0]
            parts = []
            reuse = min(len(sel), len(self._free[s]))
            if reuse:
                parts.append(self._free[s][-reuse:])
                self._free[s] = self._free[s][:-reuse]
            fresh = len(sel) - reuse
            if fresh:
                start = int(self._shard_next[s])
                parts.append(np.arange(start, start + fresh, dtype=np.int64)
                             + s * self.shard_capacity)
                self._shard_next[s] += fresh
            rows[sel] = np.concatenate(parts) if len(parts) > 1 \
                else parts[0]
        return rows

    def _ensure_capacity(self, need_per_shard: np.ndarray) -> None:
        """Grow until every block absorbs ``need_per_shard`` more rows;
        free-list slots count as available (steady activate/evict churn
        never grows the arena)."""
        need = np.asarray(need_per_shard, dtype=np.int64)
        free_counts = np.array([len(f) for f in self._free], dtype=np.int64)
        while np.any(self._shard_next + np.maximum(need - free_counts, 0)
                     > self.shard_capacity):
            self._grow()  # remaps the free lists; their counts stand

    def _activate_keys(self, keys: np.ndarray) -> None:
        if len(keys) and int(keys.min()) < 0:
            # the row map's free-slot sentinel is -1: the grain key
            # domain is [0, 2**63)
            raise ValueError(
                f"arena {self.info.name}: grain keys must be in "
                f"[0, 2**63); got {int(keys.min())}")
        if len(keys) and int(keys.max()) >= KEY_SENTINEL:
            self.has_wide_keys = True
        shards = self.home_shards(keys)
        self._ensure_capacity(np.bincount(shards, minlength=self.n_shards))
        rows = self._take_rows(shards)
        self._key_of_row[rows] = keys
        self.live_count += len(keys)
        self._dirty = True
        if self.store is not None:
            self._load_persisted(keys)

    def _load_persisted(self, keys: np.ndarray) -> None:
        """Activation stage 2, batched: scatter persisted rows (evicted
        earlier) into the freshly allocated rows with K3 SET (reference:
        Catalog.SetupActivationState, Catalog.cs:731)."""
        stored = self.store.read_many(self.info.name, keys.tolist())
        if not stored:
            return
        found = np.array(sorted(stored), dtype=np.int64)
        rows, ok = self.lookup_rows(found)
        assert ok.all()
        dst = host_upload(rows.astype(np.int32), self.device)
        for name, f in self.info.state_fields.items():
            vals = np.stack([np.asarray(stored[int(k)][name]) for k in found])
            col = self.state[name]
            row_scatter(col, dst, host_upload(
                vals.astype(np_dtype(col.dtype)), self.device), "set")
        self.restored_count += len(found)

    # -- growth -------------------------------------------------------------

    def _grow(self) -> None:
        """Double every shard block.  At one block every row keeps its
        index, so the old columns copy into the front of the new ones and
        the free list stands (its rows are init-valued in the copy).  With
        several blocks each block's rows keep their offset in it, so row
        ``s * old + o`` moves to ``s * new + o`` (K13 gather of the live
        rows, K3 SET into the new columns) and the free lists remap alike.
        The generation bumps either way: every column tensor is new."""
        self._settle_owner_chain()
        old_per = self.shard_capacity
        new_per = old_per * 2
        old = self.capacity
        new_capacity = new_per * self.n_shards
        if self.n_shards == 1:
            live = np.nonzero(self._key_of_row >= 0)[0]
            moved_from = moved_to = live
        else:
            moved_from = np.nonzero(self._key_of_row >= 0)[0]
            moved_to = (moved_from // old_per) * new_per + moved_from % old_per
        new_state: Dict[str, torch.Tensor] = {}
        last_use = torch.zeros(new_capacity, dtype=torch.int32,
                               device=self.device)
        if self.n_shards == 1:
            for name, f in self.info.state_fields.items():
                col = self._make_column(f, new_capacity)
                col[:old] = self.state[name]
                new_state[name] = col
            last_use[:old] = self.last_use_dev
        else:
            src = host_upload(moved_from.astype(np.int32), self.device)
            dst = host_upload(moved_to.astype(np.int32), self.device)
            for name, f in self.info.state_fields.items():
                col = self._make_column(f, new_capacity)
                if len(moved_from):
                    row_scatter(col, dst, gather_rows(self.state[name], src),
                                "set")
                new_state[name] = col
            if len(moved_from):
                row_scatter(last_use, dst,
                            gather_rows(self.last_use_dev, src), "set")
        key_of_row = np.full(new_capacity, -1, dtype=np.int64)
        key_of_row[moved_to] = self._key_of_row[moved_from]
        last_use_tick = np.zeros(new_capacity, dtype=np.int64)
        last_use_tick[moved_to] = self.last_use_tick[moved_from]
        # replica groups ride the same block-preserving row map
        if self._replicas and self.n_shards > 1:
            self._replicas = {
                k: (r // old_per) * new_per + r % old_per
                for k, r in self._replicas.items()}
        secondary = np.zeros(new_capacity, dtype=bool)
        secondary[moved_to] = self._replica_secondary[moved_from]
        self._replica_secondary = secondary
        self._dev_replicas_stale = True
        att = self._attribution()
        if att is not None:
            # traffic counts move with their rows
            att.remap_rows(self, moved_from, moved_to, new_capacity)

        self.state = new_state
        self.last_use_dev = last_use
        self.shard_capacity = new_per
        self.capacity = new_capacity
        self._key_of_row = key_of_row
        self.last_use_tick = last_use_tick
        # free slots ride along: row s*old_per + o → s*new_per + o (the new
        # columns are init-valued wherever no live row landed)
        self._free = [s * new_per + (f - s * old_per)
                      for s, f in enumerate(self._free)]
        self._dirty = True
        self.generation += 1

    def reserve(self, n: int) -> None:
        """Pre-size so ~n activations fit without growth mid-run."""
        per_shard_target = -(-n // self.n_shards)
        while self.shard_capacity < per_shard_target * 2:
            self._grow()

    # -- collection (reference: ActivationCollector.cs:37) ---------------

    def rows_to_host(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Gather ``rows``' state columns to the host: one K13 gather per
        column on the current stream, then one wait for every copy.  Eager
        PyTorch has no compile set to bound, so the rows go unpadded."""
        idx = host_upload(np.asarray(rows, dtype=np.int32), self.device)
        return fetch_host({name: gather_rows(col, idx)
                       for name, col in self.state.items()})

    def shard_occupancy(self) -> np.ndarray:
        """Live rows per shard block (int64[n_shards]; replica
        secondaries count in the block that holds them)."""
        live = np.nonzero(self._key_of_row >= 0)[0]
        return np.bincount(live // self.shard_capacity,
                           minlength=self.n_shards).astype(np.int64)

    def fragmentation(self) -> float:
        """The worst block's freed/high-water ratio (0.0 = no holes): the
        threshold trigger for compaction."""
        hw = np.maximum(self._shard_next, 1).astype(np.float64)
        free = np.array([len(f) for f in self._free], dtype=np.float64)
        return float((free / hw).max())

    def select_idle_rows(self, older_than_tick: int) -> np.ndarray:
        """Victim selection: one K12 compare over both use clocks on the
        device; only the bool victim mask crosses to the host, with one
        copy on the current stream after every tick enqueued there.
        Returns victim row ids (host int64)."""
        # settle BEFORE computing victims: a settle-triggered replay may
        # grow this arena, which would invalidate the row ids
        self._settle_owner_chain()
        live = self._key_of_row >= 0
        if not live.any():
            return np.empty(0, dtype=np.int64)
        cutoff = int(np.clip(older_than_tick, -2**31 + 1, 2**31 - 1))
        # the host clock as ``last_use`` reads it: a fused window's O(1)
        # stamp counts for every row live at its end
        host_clock = np.clip(np.maximum(self.last_use_tick,
                                        self.fused_use_tick),
                             0, 2**31 - 1).astype(np.int32)
        mask = idle_mask(self.last_use_dev,
                         host_upload(host_clock, self.device),
                         host_upload(live, self.device), cutoff)
        return np.flatnonzero(mask.cpu().numpy()).astype(np.int64)

    def deactivate_idle_rows(self, rows: np.ndarray, older_than_tick: int,
                             write_back: bool = True) -> int:
        """Deactivate the subset of ``rows`` still live and still idle —
        the re-validated chunk step of incremental collection.  Rows
        touched (either clock) since their sweep selected them are
        spared; a row reused by another key stays eligible only if that
        key is itself idle past the cutoff."""
        self._settle_owner_chain()
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[(rows >= 0) & (rows < self.capacity)]
        rows = rows[self._key_of_row[rows] >= 0]
        if len(rows) == 0:
            return 0
        idx = host_upload(rows.astype(np.int32), self.device)
        dev = fetch_host({"c": gather_rows(self.last_use_dev, idx)})["c"]
        idle = np.maximum(self.last_use(rows),
                          dev.astype(np.int64)) < older_than_tick
        return self._deactivate_rows(rows[idle], write_back)

    def collect(self, older_than_tick: int, write_back: bool = True) -> int:
        """Deactivate rows idle since before ``older_than_tick`` (the
        age-based sweep, reference: Catalog.cs:836): victims are written
        back first when a store is attached, then their rows return to
        the free list in place.  Returns the number of rows evicted."""
        return self._deactivate_rows(
            self.select_idle_rows(older_than_tick), write_back)

    def evict_keys(self, keys: np.ndarray, write_back: bool = True) -> int:
        """Deactivate specific keys (write-back first when a store is
        attached; reference: GrainDirectoryHandoffManager.cs:141).  A
        replicated key folds back to its primary first, so the write-back
        stores the merged state and the secondaries free by demotion."""
        self._settle_owner_chain()
        keys = np.asarray(keys, dtype=np.int64)
        if self._replicas:
            for k in keys.tolist():
                if int(k) in self._replicas:
                    self.demote_replicas(int(k))
        rows, found = self.lookup_rows(keys)
        return self._deactivate_rows(rows[found].astype(np.int64),
                                     write_back)

    def _deactivate_rows(self, victims: np.ndarray, write_back: bool) -> int:
        """Shared deactivation tail: write-back FIRST (victims are freed
        only after the store returns, so a storage fault mid-chunk leaves
        them live for the retry), then the rows return to the free list
        in place.  Rows do not move: the generation stands and only
        ``eviction_epoch`` bumps.  Callers settle the owner chain before
        they compute victims."""
        victims = np.asarray(victims, dtype=np.int64)
        if self._replicas:
            # replica members never collect one by one: demotion is their
            # only exit (evict_keys demotes first)
            victims = victims[~self._replica_member_mask(victims)]
        if len(victims) == 0:
            return 0
        keys = self._key_of_row[victims]
        att = self._attribution()
        if att is not None:
            # retire the victims' traffic per key BEFORE their rows free:
            # a reused row must never inherit the evicted grain's counts
            att.on_evict(self, victims, keys)
        for route in self._stream_routes():
            # retire subscribed victims from the pull layout BEFORE their
            # rows can be reused (a reused row must never receive a dead
            # subscription's events); with none subscribed the route's
            # stamp adopts the epoch bumped below
            route.on_evict(self, victims, keys)
        if write_back and self.store is not None:
            self.store.write_many_columnar(
                self.info.name, keys.tolist(), self.rows_to_host(victims))
        self._key_of_row[victims] = -1
        self.live_count -= len(victims)
        self.evicted_count += len(victims)
        self._free_rows(victims)
        self.eviction_epoch += 1
        self._dirty = True
        if 0.0 < self.compact_fragmentation <= 1.0 \
                and self.fragmentation() > self.compact_fragmentation:
            self._compact()
        return len(victims)

    def _free_rows(self, victims: np.ndarray) -> None:
        """Return freed rows to their blocks' free lists and scrub them in
        place: the state columns back to their field inits with one K3 SET
        of a host scalar per field, both use clocks to 0.  In place, so the
        columns keep their addresses."""
        if self.n_shards == 1:
            self._free[0] = np.concatenate([self._free[0], victims])
        else:
            shards = victims // self.shard_capacity
            order = np.argsort(shards, kind="stable")
            bounds = np.searchsorted(shards[order],
                                     np.arange(self.n_shards + 1))
            ordered = victims[order]
            for s in range(self.n_shards):
                part = ordered[bounds[s]:bounds[s + 1]]
                if len(part):
                    self._free[s] = np.concatenate([self._free[s], part])
        idx = host_upload(victims.astype(np.int32), self.device)
        for name, f in self.info.state_fields.items():
            row_scatter(self.state[name], idx, f.init, "set")
        row_scatter(self.last_use_dev, idx, 0, "set")
        self.last_use_tick[victims] = 0

    def _compact(self) -> None:
        """Repack each block so its live rows are contiguous from the
        block's base (the free lists clear; each bump pointer resets to
        its block's live count).  Rows move, so the generation bumps and
        holders re-resolve; the columns are built anew (K13 gather of the
        old rows, K3 SET into the new), which the rebuild the generation
        forces allows."""
        old_rows = np.nonzero(self._key_of_row >= 0)[0]
        # old_rows ascend, so each block's members are contiguous: their
        # rank in the block is the index minus the block's start
        shards = old_rows // self.shard_capacity
        next_free = np.bincount(shards, minlength=self.n_shards) \
            .astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(next_free)[:-1]))
        new_rows = (shards * self.shard_capacity
                    + np.arange(len(old_rows)) - starts[shards])
        keys = self._key_of_row[old_rows]
        last_use = self.last_use_tick[old_rows]
        self._key_of_row.fill(-1)
        self._key_of_row[new_rows] = keys
        self.last_use_tick.fill(0)
        self.last_use_tick[new_rows] = last_use
        self._shard_next = next_free
        self._free = [np.empty(0, dtype=np.int64)
                      for _ in range(self.n_shards)]

        src = host_upload(old_rows.astype(np.int32), self.device)
        dst = host_upload(new_rows.astype(np.int32), self.device)
        for name, f in self.info.state_fields.items():
            col = self._make_column(f, self.capacity)
            row_scatter(col, dst, gather_rows(self.state[name], src), "set")
            self.state[name] = col
        last_use_dev = torch.zeros(self.capacity, dtype=torch.int32,
                                   device=self.device)
        row_scatter(last_use_dev, dst, gather_rows(self.last_use_dev, src),
                    "set")
        self.last_use_dev = last_use_dev
        att = self._attribution()
        if att is not None:
            att.remap_rows(self, old_rows, new_rows, self.capacity)
        if self._replicas:
            remap = np.full(self.capacity, -1, dtype=np.int64)
            remap[old_rows] = new_rows
            self._replicas = {k: remap[r] for k, r in self._replicas.items()}
            secondary = np.zeros(self.capacity, dtype=bool)
            secondary[new_rows] = self._replica_secondary[old_rows]
            self._replica_secondary = secondary
            self._dev_replicas_stale = True
        self._dirty = True
        self.generation += 1

    # -- live migration (batched deactivate-with-state-handoff) --------------

    def migrate_keys(self, keys: np.ndarray, dst_shards,
                     pin: bool = True) -> int:
        """Batched live migration of grains into explicit destination
        blocks: one K13 gather and one K3 SET per state column (and the
        device use clock) move k grains' rows, never per-grain Python.  An
        atomic deactivate-with-state-handoff → reactivate on the target
        block: the freed rows return to their free lists scrubbed, the
        eviction epoch bumps (holders of pre-move rows re-validate and
        deliver again through the miss path), and the attribution plane
        retires the movers' counts per key before the move.  Stream
        routes keep their subscriptions (``on_migrate``).  ``pin`` records
        a move off the hash block in ``_shard_override``, so an evict →
        reactivate cycle returns the grain to its migrated block.  The
        generation stands: the rows of unmigrated keys stay put.  Keys
        already in their destination, unknown keys and replicated keys
        (demote first) do not move.  Returns the grains moved."""
        self._settle_owner_chain()
        keys = np.asarray(keys, dtype=np.int64)
        dst = np.broadcast_to(np.asarray(dst_shards, dtype=np.int64),
                              keys.shape).copy()
        keys, first = np.unique(keys, return_index=True)
        dst = dst[first]  # duplicate keys: the first destination wins
        if len(keys) and (int(dst.min()) < 0
                          or int(dst.max()) >= self.n_shards):
            raise ValueError(
                f"arena {self.info.name}: migration destination shard "
                f"out of range [0, {self.n_shards})")
        rows, found = self.lookup_rows(keys)
        cur = rows.astype(np.int64) // self.shard_capacity
        sel = found & (dst != cur)
        if self._replicas:
            sel &= ~np.isin(keys, np.fromiter(
                self._replicas, np.int64, len(self._replicas)))
        keys, dst = keys[sel], dst[sel]
        if len(keys) == 0:
            return 0
        # capacity first: growth moves rows, so the sources resolve after
        self._ensure_capacity(np.bincount(dst, minlength=self.n_shards))
        src_rows, found = self.lookup_rows(keys)
        assert found.all()
        src_rows = src_rows.astype(np.int64)
        att = self._attribution()
        if att is not None:
            # the movers' traffic retires per key before the move: counts
            # follow the key, the freed row restarts at zero
            att.on_evict(self, src_rows, keys)
        for route in self._stream_routes():
            # subscriptions survive a migration; only the row-addressed
            # pull layout goes stale
            route.on_migrate(self, keys)
        new_rows = self._take_rows(dst)
        src = host_upload(src_rows.astype(np.int32), self.device)
        dst_idx = host_upload(new_rows.astype(np.int32), self.device)
        for name in self.info.state_fields:
            col = self.state[name]
            row_scatter(col, dst_idx, gather_rows(col, src), "set")
        row_scatter(self.last_use_dev, dst_idx,
                    gather_rows(self.last_use_dev, src), "set")
        # the host identity flips in one step: new rows bind, old rows free
        self.last_use_tick[new_rows] = self.last_use_tick[src_rows]
        self._key_of_row[new_rows] = keys
        self._key_of_row[src_rows] = -1
        self._free_rows(src_rows)
        home = shard_of_keys(keys, self.n_shards)
        for k, d, h in zip(keys.tolist(), dst.tolist(), home.tolist()):
            if pin and d != h:
                self._shard_override[k] = d
            else:
                # back on (or landing on) its hash block: no pin needed
                self._shard_override.pop(k, None)
        self._override_sorted = None
        self.migrated_count += len(keys)
        self.eviction_epoch += 1
        self._dirty = True
        return len(keys)

    # -- hot-grain replicas (the JAX arena's promote/demote at one block) ---
    # A grain too hot for one row, whose state folds commutatively
    # (StateField.fold), promotes to k rows; delivery scatters its lanes
    # over the group by lane hash and reads fold the group back.

    REPLICA_TABLE_WIDTH = 8  # the mirror's row width; k is capped to it

    def _replica_mirror_host(self) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """(prim, counts, table) as host arrays — the one construction both
        the device mirror and the host twin derive from, so the two
        spreads agree bit for bit."""
        items = sorted(self._replicas.items(), key=lambda kv: int(kv[1][0]))
        alloc = 1 << max(0, len(items) - 1).bit_length()
        kmax = self.REPLICA_TABLE_WIDTH
        prim = np.full(alloc, KEY_SENTINEL, dtype=np.int32)
        counts = np.ones(alloc, dtype=np.int32)
        table = np.full((alloc, kmax), -1, dtype=np.int32)
        for i, (_, rws) in enumerate(items):
            k = min(len(rws), kmax)
            prim[i] = int(rws[0])
            counts[i] = k
            table[i, :k] = rws[:k]
        return prim, counts, table

    def replica_mirror(self) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """K18's mirror on the device, row-keyed (any key width), cached
        until a promote, a demote or a row move stales it.  A fused window
        bakes these tensors; every change that stales them bumps the
        generation, which rebuilds the window."""
        if self._dev_replicas_stale or self._dev_replicas is None:
            self._dev_replicas = tuple(
                self._to_device(a) for a in self._replica_mirror_host())
            self._dev_replicas_stale = False
        return self._dev_replicas

    def spread_rows_host(self, rows: np.ndarray) -> np.ndarray:
        """Host twin of K18: the same lane-hash replica choice applied to
        host-resolved rows (the injector's refresh, the host resolution of
        a batch, a fused window's static source rows)."""
        rows = np.asarray(rows)
        if not self._replicas or len(rows) == 0:
            return rows
        prim, counts, table = self._replica_mirror_host()
        r = rows.astype(np.int64)
        idx = np.clip(np.searchsorted(prim, r), 0, len(prim) - 1)
        hit = (prim[idx].astype(np.int64) == r) & (r >= 0)
        lanes = np.arange(len(r), dtype=np.uint32)
        h = (lanes * np.uint32(2654435761)) >> np.uint32(8)
        choice = (h % counts[idx].astype(np.uint32)).astype(np.int64)
        alt = table[idx, choice].astype(np.int64)
        out = np.where(hit & (alt >= 0), alt, r)
        return out.astype(rows.dtype)

    def _replica_member_mask(self, rows: np.ndarray) -> np.ndarray:
        """True for rows inside any replica group (primary or secondary):
        those never collect or evict one by one."""
        rows = np.asarray(rows, dtype=np.int64)
        mask = self._replica_secondary[rows].copy()
        if self._replicas:
            prim = np.fromiter((int(r[0]) for r in self._replicas.values()),
                               np.int64, len(self._replicas))
            mask |= np.isin(rows, prim)
        return mask

    def promote_replicas(self, key: int, k: int) -> int:
        """Promote ``key`` to ``k`` replica rows (2 ≤ k ≤ 8): its row stays
        the primary, k - 1 secondaries come off the other shard blocks,
        round-robin (free list first, then the bump pointer).  They hold
        field inits — the fold identity — so a fresh replica adds nothing
        to the merge.  The generation bumps (a fused window rebuilds; the
        next checkpoint is a full one) and so does the eviction epoch
        (held rows re-check).  Returns the group size; a key already
        promoted keeps its group."""
        k = int(max(2, min(k, self.REPLICA_TABLE_WIDTH)))
        self._settle_owner_chain()
        key = int(key)
        if key in self._replicas:
            return len(self._replicas[key])
        _, found = self.lookup_rows(np.array([key], dtype=np.int64))
        if not found[0]:
            raise KeyError(f"arena {self.info.name}: cannot replicate key "
                           f"{key} — not live")
        # the secondaries land on the OTHER blocks, round-robin (all on
        # the one block of a one-block arena)
        prim_shard = int(self.lookup_rows(
            np.array([key], dtype=np.int64))[0][0]) // self.shard_capacity
        if self.n_shards > 1:
            others = [s for s in range(self.n_shards) if s != prim_shard]
            shards = np.array([others[i % len(others)]
                               for i in range(k - 1)], dtype=np.int64)
        else:
            shards = np.zeros(k - 1, dtype=np.int64)
        self._ensure_capacity(np.bincount(shards, minlength=self.n_shards))
        # look the primary up again: growth may have moved it
        prow, found = self.lookup_rows(np.array([key], dtype=np.int64))
        assert found[0]
        prow = int(prow[0])
        sec = self._take_rows(shards)
        self._key_of_row[sec] = key
        self._replica_secondary[sec] = True
        self._replicas[key] = np.concatenate(
            [np.array([prow], dtype=np.int64), sec])
        self.last_use_tick[sec] = self.last_use_tick[prow]
        self.replica_promotions += 1
        self._dirty = True
        self._dev_replicas_stale = True
        self.generation += 1
        self.eviction_epoch += 1
        return k

    def _fold_replica_host(self, rws: np.ndarray) -> Dict[str, np.ndarray]:
        """One group's merged state on the host (its rows gathered by
        K13): fold "sum" as Σ rows − (k − 1)·init, exact for integer
        columns; "max" and "min" directly (their identity is the init by
        declaration)."""
        rws = np.asarray(rws, dtype=np.int64)
        host = self.rows_to_host(rws)
        k = len(rws)
        out: Dict[str, np.ndarray] = {}
        for name, f in self.info.state_fields.items():
            vals = host[name]
            if f.fold == "max":
                out[name] = vals.max(axis=0)
            elif f.fold == "min":
                out[name] = vals.min(axis=0)
            else:
                dtype = np_dtype(self.state[name].dtype)
                init = np.asarray(f.init, dtype=dtype)
                out[name] = (vals.sum(axis=0, dtype=vals.dtype)
                             - np.asarray(k - 1, dtype=dtype) * init
                             ).astype(dtype)
        return out

    def demote_replicas(self, key: int) -> int:
        """Fold ``key``'s group back into its primary and free the
        secondaries: the merged row is written with K3 SET, the clocks
        merge (the primary takes the group's latest use), the attribution
        plane retires the secondaries' counts under the key, and the rows
        return to the free list scrubbed.  Not an eviction: no write-back
        and no stream-route retirement.  Returns the secondaries freed (0
        for a key not replicated)."""
        # settle first: a replay may grow or compact and remap the group
        self._settle_owner_chain()
        key = int(key)
        rws = self._replicas.pop(key, None)
        if rws is None:
            return 0
        rws = np.asarray(rws, dtype=np.int64)
        prow = int(rws[0])
        sec = rws[1:]
        merged = self._fold_replica_host(rws)
        dst = host_upload(np.array([prow], dtype=np.int32), self.device)
        for name, f in self.info.state_fields.items():
            col = self.state[name]
            val = np.asarray(merged[name], dtype=np_dtype(col.dtype))
            row_scatter(col, dst, host_upload(
                val.reshape((1, *f.shape)), self.device), "set")
        idx = host_upload(rws.astype(np.int32), self.device)
        dev = fetch_host({"c": gather_rows(self.last_use_dev, idx)})["c"]
        row_scatter(self.last_use_dev, dst, int(dev.max()), "max")
        self.last_use_tick[prow] = int(self.last_use_tick[rws].max())
        att = self._attribution()
        if att is not None:
            # the secondaries' traffic retires under the key before their
            # rows can be reused: totals survive a demote as an eviction
            att.on_evict(self, sec, np.full(len(sec), key, dtype=np.int64))
        self._key_of_row[sec] = -1
        self._replica_secondary[sec] = False
        self._free_rows(sec)
        self.replica_demotions += 1
        self.replica_folds += 1
        self._dirty = True
        self._dev_replicas_stale = True
        self.generation += 1
        self.eviction_epoch += 1
        return len(sec)

    # -- checkpoint (tick-consistent full-arena write) -----------------------

    def checkpoint(self) -> int:
        """Write every live row through the store: with the engine
        quiesced, a tick-consistent snapshot of the whole arena at
        per-grain record granularity.  A replicated key's record is its
        fold, so a restore into an unreplicated arena is exact."""
        if self.store is None:
            raise RuntimeError(f"arena {self.info.name} has no store")
        live_rows = np.nonzero(self._key_of_row >= 0)[0]
        if self._replicas:
            live_rows = live_rows[~self._replica_secondary[live_rows]]
        if len(live_rows) == 0:
            return 0
        keys = self._key_of_row[live_rows]
        cols = self.rows_to_host(live_rows)
        if self._replicas:
            pos = {int(kk): i for i, kk in enumerate(keys.tolist())}
            for kk, rws in self._replicas.items():
                folded = self._fold_replica_host(rws)
                i = pos[int(kk)]
                for name in cols:
                    cols[name][i] = folded[name]
        self.store.write_many_columnar(self.info.name, keys.tolist(), cols)
        return len(live_rows)

    def restore_from_store(self) -> int:
        """Activate (and load) every key the store holds for this type —
        resume after a process restart."""
        if self.store is None:
            raise RuntimeError(f"arena {self.info.name} has no store")
        keys = self.store.list_keys(self.info.name)
        fresh = keys[~self.lookup_rows(keys)[1]] if len(keys) else keys
        if len(fresh):
            self._activate_keys(fresh)
        return len(fresh)

    # -- durable state plane (tensor/checkpoint.py) --------------------------

    def host_clock(self) -> np.ndarray:
        """The host use clock as the JAX arena keeps it: a fused window's
        O(1) stamp counts for every row live now (the JAX window stamps
        each live row; a row activated since holds a later stamp)."""
        if not self.fused_use_tick:
            return self.last_use_tick.copy()
        return np.where(self._key_of_row >= 0,
                        np.maximum(self.last_use_tick, self.fused_use_tick),
                        self.last_use_tick)

    def export_layout(self) -> Dict[str, Any]:
        """Host-side identity metadata of a consistent cut: the key→row
        map, the bump pointer, generation, eviction epoch, the host use
        clock and the replica groups (primary first) — the JAX package's
        layout at one shard block.  Copies, so the live arena can keep
        changing while the snapshot drains."""
        return {
            "capacity": int(self.capacity),
            "n_shards": int(self.n_shards),
            "shard_capacity": int(self.shard_capacity),
            "generation": int(self.generation),
            "eviction_epoch": int(self.eviction_epoch),
            "live_count": int(self.live_count),
            "has_wide_keys": bool(self.has_wide_keys),
            "key_of_row": self._key_of_row.copy(),
            "last_use_tick": self.host_clock(),
            "shard_next": self._shard_next.copy(),
            "shard_override": dict(self._shard_override),
            "replicas": {int(k): [int(x) for x in r]
                         for k, r in self._replicas.items()},
        }

    def _rebuild_free_lists(self) -> None:
        """The free lists from first principles: every slot of a block
        below its bump pointer not holding a key, ascending (LIFO order
        only biases reuse toward recently freed slots; it is not
        identity)."""
        self._free = []
        for s in range(self.n_shards):
            blk = np.arange(int(self._shard_next[s]), dtype=np.int64) \
                + s * self.shard_capacity
            self._free.append(blk[self._key_of_row[blk] < 0])

    def _layout_changed(self) -> None:
        self._dirty = True
        self._dev_index_stale = True
        self._dev_dense_stale = True
        self._dev_wide_stale = True
        self._dev_replicas_stale = True
        self.restore_epoch += 1

    def adopt_layout(self, meta: Dict[str, Any], key_of_row: np.ndarray,
                     last_use_tick: np.ndarray, shard_next: np.ndarray, *,
                     init_columns: bool = True,
                     replace: bool = False) -> None:
        """Restore a FULL snapshot's layout onto this (empty, freshly
        restarted) arena: exact key→row map, bump pointer, free list,
        generation, eviction epoch and replica groups.  Columns
        re-initialise to field inits unless ``init_columns=False`` (the
        fast restore follows with ``adopt_columns``).  ``replace=True``
        permits adoption over a non-empty arena (a warm standby re-basing
        onto a newer full)."""
        self._settle_owner_chain()
        if self.live_count and not replace:
            raise RuntimeError(
                f"arena {self.info.name}: adopt_layout needs an empty "
                f"arena (restore happens before traffic)")
        if int(meta["n_shards"]) != 1 or self.n_shards != 1 \
                or meta.get("shard_override"):
            raise NotImplementedError(
                f"arena {self.info.name}: a recovery point of "
                f"{meta['n_shards']} shard blocks or with migration pins "
                f"{_RESHARD}")
        self.capacity = int(meta["capacity"])
        self.shard_capacity = self.capacity  # one block (checked above)
        self._key_of_row = np.asarray(key_of_row, dtype=np.int64).copy()
        self._shard_next = np.asarray(shard_next, dtype=np.int64).copy()
        self.last_use_tick = np.asarray(last_use_tick, dtype=np.int64).copy()
        self.fused_use_tick = 0
        self._rebuild_free_lists()
        self._replicas = {int(k): np.asarray(v, dtype=np.int64)
                          for k, v in meta.get("replicas", {}).items()}
        self._replica_secondary = np.zeros(self.capacity, dtype=bool)
        for r in self._replicas.values():
            self._replica_secondary[r[1:]] = True
        self._dev_replicas = None
        # secondaries occupy slots but are not activations
        self.live_count = int((self._key_of_row >= 0).sum()
                              - self._replica_secondary.sum())
        self.generation = int(meta["generation"])
        self.eviction_epoch = int(meta["eviction_epoch"])
        self.has_wide_keys = bool(meta.get("has_wide_keys", False))
        if init_columns:
            self._init_state_columns(self.capacity)
            self.last_use_dev = torch.zeros(self.capacity, dtype=torch.int32,
                                            device=self.device)
        self._dev_sorted_keys = self._dev_sorted_rows = None
        self._dev_dense = self._dev_wide = None
        self._layout_changed()

    def adopt_columns(self, columns: Dict[str, np.ndarray],
                      last_use_dev: np.ndarray) -> None:
        """The fast restore's companion of ``adopt_layout(init_columns=
        False)``: adopt host-assembled full-capacity columns wholesale, one
        upload per column from pinned memory."""
        new_state: Dict[str, torch.Tensor] = {}
        for name, f in self.info.state_fields.items():
            col = np.asarray(columns[name])
            want = (self.capacity, *f.shape)
            if col.shape != want or col.dtype != np_dtype(f.dtype):
                raise ValueError(
                    f"arena {self.info.name}: adopt_columns {name} "
                    f"{col.shape}/{col.dtype} != {want}/{f.dtype}")
            new_state[name] = host_upload(col, self.device)
        dev = np.asarray(last_use_dev, np.int32)
        if dev.shape != (self.capacity,):
            raise ValueError(
                f"arena {self.info.name}: adopt_columns last_use_dev "
                f"{dev.shape} != ({self.capacity},)")
        self.last_use_dev = host_upload(dev, self.device)
        self.state = new_state
        self._layout_changed()

    def adopt_delta(self, meta: Dict[str, Any], rows: np.ndarray,
                    keys: np.ndarray, live_keys: np.ndarray,
                    shard_next: np.ndarray,
                    last_use_tick: Optional[np.ndarray] = None) -> None:
        """Advance a restored layout by one incremental delta: free keys no
        longer live at the delta's cut, free the stale slots of keys that
        moved (evict and reactivate between checkpoints), place the dirty
        (row, key) set at its recorded rows — legal because deltas never
        span a generation change.  Freed slots scrub in place to field
        inits (K3 SET), the free-list invariant every reuse path
        assumes."""
        self._settle_owner_chain()
        if int(meta["generation"]) != self.generation \
                or int(meta["capacity"]) != self.capacity:
            raise RuntimeError(
                f"arena {self.info.name}: delta layout mismatch "
                f"(generation {meta['generation']} vs {self.generation})"
                f" — deltas must not span a row move")
        if meta.get("shard_override"):
            raise NotImplementedError(
                f"arena {self.info.name}: migration pins {_RESHARD}")
        rows = np.asarray(rows, dtype=np.int64)
        keys = np.asarray(keys, dtype=np.int64)
        # 1. keys dead at the delta's cut leave (no write-back: the
        #    snapshot is the storage)
        cur_live = np.nonzero(self._key_of_row >= 0)[0]
        dead = cur_live[~np.isin(self._key_of_row[cur_live], live_keys)]
        # 2. stale slots of keys that moved since the base snapshot
        lookup, found = self.lookup_rows(keys)
        moved = found & (lookup.astype(np.int64) != rows)
        if self._replicas:
            # a secondary row's key looks up to its PRIMARY row: without
            # this guard the primary slot would be freed as "stale"
            moved &= ~self._replica_secondary[rows]
        stale = lookup[moved].astype(np.int64)
        freed = np.unique(np.concatenate([dead, stale]))
        if len(freed):
            self._key_of_row[freed] = -1
            self.last_use_tick[freed] = 0
            idx = host_upload(freed.astype(np.int32), self.device)
            for name, f in self.info.state_fields.items():
                row_scatter(self.state[name], idx, f.init, "set")
            row_scatter(self.last_use_dev, idx, 0, "set")
        # 3. the dirty set lands at its recorded rows
        self._key_of_row[rows] = keys
        if last_use_tick is not None:
            # the delta records the full host use clock at its cut
            self.last_use_tick = np.asarray(last_use_tick,
                                            dtype=np.int64).copy()
            self.fused_use_tick = 0
        self._shard_next = np.asarray(shard_next, dtype=np.int64).copy()
        self._rebuild_free_lists()
        self.live_count = int((self._key_of_row >= 0).sum()
                              - self._replica_secondary.sum())
        self.eviction_epoch = int(meta["eviction_epoch"])
        self._layout_changed()

    def scatter_restore(self, rows: np.ndarray,
                        columns: Dict[str, np.ndarray],
                        last_use_dev: np.ndarray) -> None:
        """Land restored rows at their exact rows: one K3 SET per column
        and one for the device use clock, in place."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return
        idx = host_upload(rows.astype(np.int32), self.device)
        for name, f in self.info.state_fields.items():
            col = self.state[name]
            vals = np.ascontiguousarray(np.asarray(columns[name]).astype(
                np_dtype(col.dtype), copy=False))
            row_scatter(col, idx, host_upload(vals, self.device), "set")
        row_scatter(self.last_use_dev, idx, host_upload(
            np.asarray(last_use_dev, np.int32), self.device), "set")

    # -- host access --------------------------------------------------------

    def read_row(self, key: int) -> Optional[Dict[str, np.ndarray]]:
        if int(key) in self._replicas:
            # a replicated grain's observable state is its fold
            return self._fold_replica_host(self._replicas[int(key)])
        rows, found = self.lookup_rows(np.array([key], dtype=np.int64))
        if not found[0]:
            return None
        r = int(rows[0])
        return {name: col[r].cpu().numpy() for name, col in self.state.items()}

    def keys(self) -> np.ndarray:
        live = self._key_of_row >= 0
        if self._replicas:
            live &= ~self._replica_secondary
        return self._key_of_row[live]
