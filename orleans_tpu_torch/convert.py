"""Carry an engine's state across from the JAX package.

The system has no weights; what a running cluster carries is its arenas
— the host key→row map, the state columns and the lifecycle bookkeeping
(free list, bump pointer, eviction epoch and counters, both use clocks)
— its store, its timers, its latency ledger, its workload-attribution
plane and its fan-out graphs.
``arena_state_from_numpy`` loads an arena — as numpy arrays, e.g.
``jax_arena._key_of_row`` and ``{k: np.asarray(v) for k, v in
jax_arena.state.items()}`` — into a port arena, after which both packages
compute the same next tick (an arena holding keys beyond int32 resolves
through its wide mirror, as the JAX arena does; one holding hot-grain
replica groups spreads its deliveries over them, as the JAX arena does).
``fanout_from_adjacency`` builds a port ``DeviceFanout`` from a JAX one's
adjacency lists and budget (``jax_fanout._adj``, ``jax_fanout.budget``),
after which both expand the same messages into the same slots.  ``ledger_state_from_numpy`` loads a ledger's
slots and counts, after which both report the same histogram.
``attribution_state_from_numpy`` loads an attribution plane's counts,
sketches, slot counts and retired mirror, after which both report the same
snapshot and per-key totals.  ``timers_from_jax`` loads a JAX timers
plane's host mirrors (slot for slot: key, name, due, period, stamp, the
index and the free slots) into a port plane, rebuilding its wheel and
device columns, after which both fire the same timers on the same ticks;
``store_from_jax`` copies a JAX ``MemoryVectorStore``'s records.
``subscriptions_from_jax`` builds a port ``DeviceSubscriptions`` from a
JAX one (its merged edge table, its buffered mutations, its bound key set
and its counters), after which both deliver the same events.  These read
the JAX objects' attributes only: nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from orleans_tpu_torch.tensor.arena import GrainArena
from orleans_tpu_torch.tensor.attribution import WorkloadAttribution
from orleans_tpu_torch.tensor.fanout import DeviceFanout
from orleans_tpu_torch.tensor.ledger import MAX_SLOTS, DeviceLatencyLedger
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore
from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions
from orleans_tpu_torch.tensor.timers_plane import TimersPlane


def arena_state_from_numpy(arena: GrainArena, key_of_row: np.ndarray,
                           columns: Dict[str, np.ndarray], *,
                           free_rows: Optional[np.ndarray] = None,
                           shard_next: Optional[int] = None,
                           last_use_tick: Optional[np.ndarray] = None,
                           last_use_dev: Optional[np.ndarray] = None,
                           eviction_epoch: Optional[int] = None,
                           evicted_count: int = 0,
                           restored_count: int = 0,
                           replicas: Optional[Mapping[int, Sequence[int]]]
                           = None,
                           replica_counts: Tuple[int, int, int] = (0, 0, 0)
                           ) -> None:
    """Replace ``arena``'s rows and state with ``key_of_row`` (int64
    ``[capacity]``, -1 = free row) and ``columns`` (one ``[capacity, ...]``
    array per declared field, of the field's dtype).  The arena takes the
    source's capacity and row layout; its generation bumps, so injectors
    holding rows re-resolve.

    The lifecycle bookkeeping of a JAX arena with one shard block rides
    along when given: ``free_rows`` (``jax_arena._free[0]``, in its LIFO
    order), ``shard_next`` (``jax_arena._shard_next[0]``; default: past
    the last live row), both use clocks (``jax_arena.last_use_tick``,
    ``np.asarray(jax_arena.last_use_dev)``; default zero), the eviction
    epoch and the evicted/restored counts.  So do its hot-grain replica
    groups: ``replicas`` (``jax_arena._replicas``: key → rows, the primary
    first) and ``replica_counts`` (``(replica_promotions,
    replica_demotions, replica_folds)``); the secondary mask derives from
    the groups."""
    key_of_row = np.asarray(key_of_row, dtype=np.int64)
    capacity = key_of_row.shape[0]
    fields = arena.info.state_fields
    if set(columns) != set(fields):
        raise ValueError(f"columns {sorted(columns)} != fields of "
                         f"{arena.info.name} {sorted(fields)}")
    state = {}
    for name, f in fields.items():
        col = torch.from_numpy(np.array(columns[name], copy=True))
        if col.dtype != f.dtype or tuple(col.shape) != (capacity, *f.shape):
            raise ValueError(
                f"{arena.info.name}.{name}: got {tuple(col.shape)}/"
                f"{col.dtype}, want {(capacity, *f.shape)}/{f.dtype}")
        state[name] = col.to(arena.device)
    if arena.n_shards != 1:
        raise ValueError(f"{arena.info.name}: the conversion takes an arena "
                         f"of one shard block, not {arena.n_shards}")
    live = np.nonzero(key_of_row >= 0)[0]
    arena.state = state
    arena.capacity = arena.shard_capacity = capacity
    arena._key_of_row = key_of_row.copy()
    if shard_next is None:
        shard_next = int(live[-1]) + 1 if len(live) else 0
    arena._shard_next = np.array([shard_next], dtype=np.int64)
    arena._free = [np.array(free_rows if free_rows is not None else [],
                            dtype=np.int64)]
    arena.live_count = len(live)
    arena.has_wide_keys = bool(len(live)) and \
        int(key_of_row[live].max()) >= 2**31 - 1
    arena.last_use_tick = np.zeros(capacity, dtype=np.int64) \
        if last_use_tick is None \
        else np.array(last_use_tick, dtype=np.int64)
    arena.fused_use_tick = 0
    arena.last_use_dev = torch.zeros(capacity, dtype=torch.int32) \
        if last_use_dev is None \
        else torch.from_numpy(np.array(last_use_dev, dtype=np.int32))
    arena.last_use_dev = arena.last_use_dev.to(arena.device)
    if eviction_epoch is not None:
        arena.eviction_epoch = int(eviction_epoch)
    arena.evicted_count = int(evicted_count)
    arena.restored_count = int(restored_count)
    arena._replicas = {int(k): np.array(r, dtype=np.int64)
                       for k, r in (replicas or {}).items()}
    arena._replica_secondary = np.zeros(capacity, dtype=bool)
    for key, rws in arena._replicas.items():
        if not np.all(key_of_row[rws] == key):
            raise ValueError(f"replica group of key {key}: rows {rws} do "
                             f"not all hold the key")
        arena._replica_secondary[rws[1:]] = True
    (arena.replica_promotions, arena.replica_demotions,
     arena.replica_folds) = (int(c) for c in replica_counts)
    arena._dev_replicas_stale = True
    # secondaries are rows of their key but not live grains
    arena.live_count = len(live) - int(arena._replica_secondary.sum())
    arena._dirty = True
    arena.generation += 1


def ledger_state_from_numpy(ledger: DeviceLatencyLedger,
                            slot_names: Sequence[Tuple[str, str]],
                            host_counts: np.ndarray,
                            device_counts: Optional[np.ndarray]) -> None:
    """Load a ledger: ``slot_names`` lists the (type, method) of each slot
    in slot order (the JAX ledger's ``slots.items()`` sorted by slot);
    ``host_counts`` is its host mirror and ``device_counts`` its device
    histogram (``np.asarray(jax_ledger._hist)``, or None when it has none),
    both ``[MAX_SLOTS, n_buckets]``.  The port ledger must have no slots
    yet and takes the bucket count of the arrays."""
    if len(ledger.slots):
        raise ValueError("ledger_state_from_numpy: the ledger has slots "
                         "already")
    host = np.asarray(host_counts, dtype=np.int64)
    if host.ndim != 2 or host.shape[0] != MAX_SLOTS:
        raise ValueError(f"host counts must be [{MAX_SLOTS}, buckets], "
                         f"got {host.shape}")
    ledger.configure(n_buckets=host.shape[1])
    for type_name, method in slot_names:
        ledger.slot_for(type_name, method)
    ledger._host_hist = host.copy()
    if device_counts is not None:
        dev = np.array(device_counts, dtype=np.int32)  # writable
        if dev.shape != host.shape:
            raise ValueError(f"device counts {dev.shape} != host counts "
                             f"{host.shape}")
        ledger.device_hist_in().copy_(torch.from_numpy(dev))
        ledger.device_hist_out(ledger.device_hist_in())


def attribution_state_from_numpy(
        att: WorkloadAttribution, slot_names: Sequence[Tuple[str, str]],
        counts: Mapping[str, np.ndarray], cms: Mapping[str, np.ndarray],
        slot_counts: Optional[np.ndarray],
        retired: Optional[Mapping[str, Mapping[int, int]]] = None,
        retired_rows: int = 0) -> None:
    """Load an attribution plane: ``slot_names`` lists the (type, method)
    of each slot in slot order (the JAX plane's ``slots.items()`` sorted
    by slot; slots the port already holds must agree); ``counts`` maps a
    type to its int32 ``[capacity]`` column (``np.asarray(jax_att.
    _counts[t])``, after ``flush_folds()``), ``cms`` to its ``[depth,
    width]`` sketch; ``slot_counts`` is the ``[MAX_SLOTS]`` counter array
    or None; ``retired`` the host mirror {type: {key: messages}}.  The
    arenas must be carried across first: each counts column must match
    its arena's capacity.  The plane takes the sketches' layout."""
    for i, (type_name, method) in enumerate(slot_names):
        if att.slots.slot_for(type_name, method) != i:
            raise ValueError(f"slot {i} is not ({type_name}, {method}) in "
                             f"the port's registry")
    shapes = {np.shape(s) for s in cms.values()}
    if len(shapes) > 1:
        raise ValueError(f"sketches of several layouts: {sorted(shapes)}")
    if shapes:
        depth, width = shapes.pop()
        att.configure(cms_depth=depth, cms_width=width)
        if (att.cms_depth, att.cms_width) != (depth, width):
            raise ValueError(f"sketch layout {depth}x{width} is not one the "
                             f"plane takes")
    att.reset()
    att._plans = {}

    def load(a, shape=None) -> torch.Tensor:
        a = np.array(a, dtype=np.int32)  # writable
        if shape is not None and a.shape != shape:
            raise ValueError(f"got {a.shape}, want {shape}")
        return torch.from_numpy(a).to(att.device)

    for type_name, col in counts.items():
        arena = att.engine.arenas.get(type_name)
        if arena is None or arena.capacity != len(col):
            raise ValueError(f"counts of {type_name!r} need its arena at "
                             f"capacity {len(col)} first")
        att._counts[type_name] = load(col, (arena.capacity,))
    for type_name, sk in cms.items():
        att._cms[type_name] = load(sk)
    if slot_counts is not None:
        att._slot_counts = load(slot_counts, (MAX_SLOTS,))
    att._retired = {t: {int(k): int(v) for k, v in d.items()}
                    for t, d in (retired or {}).items()}
    att.retired_rows = int(retired_rows)


def fanout_from_adjacency(adjacency: Mapping[int, Iterable[int]],
                          budget: int) -> DeviceFanout:
    """A ``DeviceFanout`` holding ``adjacency`` (source key → follower
    keys, each list in the order it was followed) under ``budget``: the
    same CSR as the source graph, so the same expansion slots."""
    fan = DeviceFanout(budget=budget)
    for src, dsts in adjacency.items():
        dsts = [int(d) for d in dsts]
        if dsts:
            fan._adj[int(src)] = dsts
            fan.edge_count += len(dsts)
    fan._dirty = True
    return fan


def timers_from_jax(plane: TimersPlane, source) -> None:
    """Load the JAX timers plane ``source``'s host mirrors into ``plane``
    slot for slot — key, due, name, period, stamp, the (key, name) → slot
    index, the free slots and the interned names — then rebuild each
    type's wheel at the port engine's tick and upload its device columns.
    Every armed due is after the source's tick, so the port engine must
    stand at the same tick.  The counters come along."""
    eng = plane.engine()
    plane._names = list(source._names)
    plane._name_ids = dict(source._name_ids)
    plane._types = {}
    for type_name, st in source._types.items():
        tt = plane._type(type_name)
        tt.cap = int(st.cap)
        tt.key_np = np.array(st.key_np, dtype=np.int64)
        tt.due_np = np.array(st.due_np, dtype=np.int64)
        tt.name_np = np.array(st.name_np, dtype=np.int32)
        tt.period_np = np.array(st.period_np, dtype=np.int64)
        tt.stamp_np = np.array(st.stamp_np, dtype=np.int64)
        tt.index = {(int(k), int(n)): int(s)
                    for (k, n), s in st.index.items()}
        tt.free = [int(s) for s in st.free]
        if tt.cap:
            plane._rebuild(tt, eng.tick_number)
            tt.sync_device()
    for name in ("fired_total", "re_armed_total", "cancelled_total",
                 "exported_total", "adopted_total", "harvests",
                 "last_harvest_width", "worst_lateness_ticks"):
        setattr(plane, name, int(getattr(source, name)))
    plane.harvest_seconds = float(source.harvest_seconds)


def store_from_jax(store) -> MemoryVectorStore:
    """A port ``MemoryVectorStore`` holding copies of the records of the
    JAX ``MemoryVectorStore`` ``store``."""
    return MemoryVectorStore({
        (t, int(k)): {n: np.array(v, copy=True) for n, v in rec.items()}
        for (t, k), rec in store._store.items()})


def subscriptions_from_jax(source, engine) -> DeviceSubscriptions:
    """A port ``DeviceSubscriptions`` on ``engine`` (or None) carrying a JAX
    one's delivery edge, merged edge table, buffered subscribe and
    unsubscribe batches, bound publish key set and host counters (copies
    of each).  Its device layouts build at the first publish, against the
    port arena's rows."""
    subs = DeviceSubscriptions(engine, source.type_name, source.method)
    subs._edges = np.array(source._edges, dtype=np.int64).reshape(-1, 2)
    subs._sub_keys_sorted = np.unique(subs._edges[:, 1])
    subs._pending_add = [np.array(p, dtype=np.int64)
                         for p in source._pending_add]
    subs._pending_remove = [np.array(p, dtype=np.int64)
                            for p in source._pending_remove]
    subs._host_dirty = bool(subs._pending_add or subs._pending_remove)
    subs.mutation_version = source.mutation_version
    if source._bound_keys is not None:
        subs.bind(source._bound_keys)
    for name in ("published_events", "delivered_events", "pull_deliveries",
                 "push_deliveries", "rebuilds", "retired_edges",
                 "dropped_lanes", "redeliveries"):
        setattr(subs, name, int(getattr(source, name)))
    return subs
