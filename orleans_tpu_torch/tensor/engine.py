"""TensorEngine: the batched tick machine (the unfused tick).

The port of ``orleans_tpu/tensor/engine.py``'s main path.  It replaces the
reference's per-message Dispatcher/MessageCenter/Scheduler traversal
(reference: Dispatcher.cs:38, MessageCenter.cs:33,
OrleansTaskScheduler.cs:37) with the tick pipeline

    collect → resolve rows (directory) → apply batched handlers → route emits

A tick runs up to ``max_rounds_per_tick`` rounds so intra-tick call chains
(grain A's handler emitting to grain B) propagate within the tick;
messages still queued after the round cap spill to the next tick.

Data movement:

* host→device once per externally injected batch; ``BatchInjector``
  caches the resolved destination rows of a stable key set on the device.
* emit routing never touches the host: each arena keeps a device mirror
  of its key→row directory, and destinations resolve on the card
  (``kernels/resolve.py``; wide ``(hi, lo)`` keys through the arena's
  two-level wide mirror, K10).  Only a scalar miss count per routed batch
  crosses to the host, and only at the miss-check drain; cold batches
  then pay one compacted miss-key fetch that activates the new rows, and
  exactly the dropped messages are delivered again (wide keys through
  the exact host path).
* a registered fan-out (``register_fanout``: a ``DeviceFanout``
  subscription graph, ``tensor/fanout.py``) expands every message its
  source method applies into messages for its subscribers on the card
  (K11); lanes past the expansion width park and expand again at the
  drain, with their original stamp.
* a registered stream route (``register_subscriptions``: a
  ``DeviceSubscriptions``, ``tensor/streams_plane.py``) fans every message
  of a stream's ingress method out to the stream's subscribers.  A
  publish of the route's bound key set queues ONE pull-mode delivery:
  the payload gathered per edge, the lanes grouped by subscriber row
  with row-aligned ``segments``, applied without resolution and reduced
  by K16, the use clock stamped by K17.  Any other publish expands
  push-mode through K11.  With ``config.stream_plane`` off the adjacency
  walks on the host instead.
* an arena holding hot-grain replicas (``replicate_key``) spreads every
  resolved row vector after resolution: lanes aimed at a replicated
  primary re-point to one of its replica rows by lane hash (K18 on the
  device; the arena's host twin for host-resolved rows, the same
  choice), so one hot grain's updates split over k rows.  Arenas without
  replicas never launch it.

Each step runs its handler eagerly (PyTorch has no trace to cache) and
records a ``torch.cuda.Event`` after it as the step's completion fence.

Every batch is stamped with its injection tick, and the latency ledger
(``tensor/ledger.py``) records each applied batch's tick delta.  At
steady state the auto-fuser (``tensor/autofuse.py``), offered every tick
first, runs whole windows of ticks as one program (``tensor/fused.py``;
on the card one replay of a captured CUDA graph).  The workload-
attribution plane (``tensor/attribution.py``) folds every executing
group's destination rows.

The grain lifecycle runs on the unfused tick.  With
``collection_idle_ticks`` set, every ``collection_every_ticks``-th tick
starts a sweep (``IncrementalCollector``: victims selected on the device
by K12) and every tick drains a pause-budgeted slice of it, writing the
victims back to the engine's ``VectorStore`` before their rows free; a
later message to an evicted grain re-activates it from the store.  The
timers plane (``tensor/timers_plane.py``) harvests the due timers of each
tick before its rounds (K15) and delivers them as one batched
``receive_reminder`` call per type.  As in the JAX package, a tick the
auto-fuser consumes runs neither: they wait for the next unfused tick.
The durable state plane (``tensor/checkpoint.py``) engages when a
``SnapshotStore`` is attached (``snapshot_store=``): every batch entering
a journaled (type, method) (``register_journal``) through ``send_batch``
or an injector appends to the device journal before it can run, and the
unfused tick ends with the plane's stage — start a due full or delta cut,
drain one pause-budgeted slice of it, seal the journal on its cadence.
``checkpoint_every_ticks`` keeps the older per-grain ``VectorStore``
write-back cadence (``checkpoint``), which the auto-fuser honours between
windows after verifying its chain.

On a clustered silo (``runtime/silo.py``) the engine carries its silo and
the silo's ``VectorRouter`` (``tensor/router.py``): ``send_batch`` routes
host-key batches by ring owner, ``make_injector`` returns a
``ClusterInjector``, a round re-checks the ownership of host-key batches
before it runs them (``_route_group``), the miss path ships remote-owned
unseen keys to their owner instead of activating them here, and the
handoff fence defers the activation of unseen keys after a ring change
until every peer has released the new view.

Under a ``ShardMesh`` (``mesh=``, tensor/mesh.py) every arena splits into
shard blocks, and with the exchange on and engaged (``tensor/exchange.py``)
a group whose batches all carry device keys is exchanged after its rows
resolve: K24 writes each lane into its destination block's region (K23's
classification where the plan is cap 0), lanes that overflow a bucket
park with copies of their keys and payload and are delivered again at the
next drain with their original stamp, and the ledger records the lanes
delivered now.  Injector batches with cached rows exchange at round start
(``_pre_exchange_round``).  Disengaged ("auto" on one card) the batch
delivers as it is and every Nth group of a site runs the probe (K23).
``migrate_keys`` moves grains between blocks live.  The profiler belongs
to a later slice of the port.

Every tensor the engine keeps past the call that handed it over — a
``send_batch`` slab, a batch spilled past the round cap, a parked
miss-check, exchange or fan-out check — is a copy taken on the stream: a
caller may rewrite its tensor in place before the tick that reads it,
where a JAX array cannot change.  Host (numpy) leaves are kept as they
are, as in the JAX package.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import weakref
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.device import host_upload, resolve_device
from orleans_tpu_torch.kernels.miss import miss_keys
from orleans_tpu_torch.kernels.replicas import spread_replicas
from orleans_tpu_torch.kernels.resolve import (
    KEY_SENTINEL,
    resolve_dense,
    resolve_sorted,
    resolve_wide,
)
from orleans_tpu_torch.tensor.arena import GrainArena, join_wide_keys
from orleans_tpu_torch.tensor.attribution import WorkloadAttribution
from orleans_tpu_torch.tensor.exchange import ShardExchange, exchangeable_args
from orleans_tpu_torch.tensor.ledger import DeviceLatencyLedger, SlotRegistry
from orleans_tpu_torch.tensor.mesh import BlockSharding, ShardMesh
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrainInfo,
    ones_mask,
    vector_type,
)

# unique unseen keys activated per miss-check pass (same bound as the JAX
# package: a cold start of more unseen keys converges over several passes)
MISS_BUF = 1 << 17

# seconds the engine loop (``TensorEngine.start``) yields between ticks
# (the JAX package's default ``tick_interval``)
LOOP_TICK_SECONDS = 0.001

# JAX runs without x64: 64-bit host arrays enter the device as 32-bit
_X32 = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
        np.dtype(np.float64): np.float32}


def _map_tree(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _map_trees(fn: Callable, *trees: Any) -> Any:
    """``_map_tree`` over several trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_trees(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_trees(fn, *xs) for xs in zip(*trees))
    if first is None:
        return None
    return fn(*trees)


def _host_array(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
    a = np.asarray(a)
    return a.astype(_X32[a.dtype]) if a.dtype in _X32 else a


def _leaf_to_device(a: Any, device: torch.device) -> Any:
    """Host arrays become device tensors (64-bit narrowed to 32-bit, as
    JAX without x64 does); tensors move to ``device``; host scalars stay
    host scalars (kernels take them by value)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, np.ndarray) and a.ndim:
        return torch.from_numpy(np.ascontiguousarray(_host_array(a))).to(
            device)
    return a


def _pad_leaf(a: Any, n: int) -> Any:
    """Zero-pad a lane-aligned leaf to ``n`` lanes (scalars broadcast)."""
    if isinstance(a, torch.Tensor):
        if a.dim() == 0 or a.shape[0] == n:
            return a
        pad = a.new_zeros((n - a.shape[0], *a.shape[1:]))
        return torch.cat([a, pad])
    a = np.asarray(a)
    if a.ndim == 0 or a.shape[0] == n:
        return a
    return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


@dataclass
class PendingBatch:
    """One queued slab of messages for a (type, method).

    Destination resolution precedence: ``rows`` while its ``generation``
    and ``epoch`` still match the arena (injector fast path), else
    ``keys_host`` (host resolution, activating unseen and evicted keys),
    else ``keys_wide`` or ``keys_dev`` (device resolution — emits, timer
    fires and miss redeliveries)."""

    args: Any                                   # tree of [m, ...] / scalars
    rows: Optional[torch.Tensor] = None         # int32[m] device
    keys_host: Optional[np.ndarray] = None      # int64[m]
    keys_dev: Optional[torch.Tensor] = None     # int32[m] device
    # wide keys as (hi, lo) int32[m] device word pairs, resolved through
    # the arena's wide mirror
    keys_wide: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    mask: Optional[torch.Tensor] = None         # bool[m] device (None = all)
    future: Optional[asyncio.Future] = None     # resolves to results[m]
    generation: int = -1                        # arena generation of rows
    epoch: int = -1                             # arena eviction epoch of rows
    # set on redeliveries whose fan-out already expanded (the wide miss
    # path): expanding again would deliver twice
    no_fanout: bool = False
    # latency ledger: the engine tick at which this batch was injected or
    # emitted (-1 = unstamped, not counted).  Miss redeliveries carry the
    # ORIGINAL stamp, so their latency includes the redelivery wait.
    inject_tick: int = -1
    # pull-mode stream delivery (tensor/streams_plane.py): row-aligned
    # edge offsets int32[capacity + 1] — the lanes are grouped by
    # destination row, ``rows`` holds each edge's row and the step's
    # reductions take K16.  Valid only while (generation, epoch) still
    # match the arena; a stale batch is delivered again by ``keys_dev``.
    segments: Optional[torch.Tensor] = None
    # exchange overlap (tensor/exchange.py): the round-start pre-dispatch
    # stores (rows2, args2, mask2, dropped, stats, generation, epoch,
    # rows identity, dispatch time, run cost) here; the group uses it only
    # while the stamps and the rows identity still match
    pre_exchange: Optional[Tuple] = None

    def __len__(self) -> int:
        for c in (self.rows, self.keys_host, self.keys_dev):
            if c is not None:
                return len(c)
        if self.keys_wide is not None:
            return len(self.keys_wide[0])
        raise ValueError("empty batch")


@dataclass
class _MissCheck:
    """A parked optimistic-resolution check (see _resolve_batch).  Its
    keys, valid mask and tensor payload leaves are copies taken when it
    was parked."""

    arena: GrainArena
    type_name: str
    method: str
    keys: Any                  # int32[m], or wide (hi, lo) int32[m] words
    valid: torch.Tensor
    rows: torch.Tensor
    miss_count: torch.Tensor
    args: Any
    inject_tick: int = -1


@dataclass
class _FanoutCheck:
    """A parked fan-out overflow check: source lanes whose expansion did
    not fit the width delivered nothing this round and carry a device-side
    dropped mask; at the next quiescence point the engine expands exactly
    those lanes again, their deliveries stamped with the ORIGINAL
    ``inject_tick``.  Its keys and tensor payload leaves are copies taken
    when it was parked."""

    expander: Any              # DeviceFanout
    dst_type: str
    dst_method: str
    keys: torch.Tensor         # int32[m] — source keys
    args: Any                  # the source payload
    dropped: torch.Tensor      # bool[m] — parked source lanes
    count: torch.Tensor        # int32 device scalar
    inject_tick: int = -1


@dataclass
class _ExchangeCheck:
    """A parked cross-shard exchange check (tensor/exchange.py): lanes that
    did not fit their destination bucket carry a device-side dropped mask,
    and at the next drain they are delivered again by key with the
    ORIGINAL inject stamp.  A disengaged exchange's probe parks one too
    (``measure_only``): its stats fold, nothing is delivered again, and
    its counts scale by the sampling factor ``scale``.  Keys and tensor
    payload leaves are copies taken when it was parked."""

    type_name: str
    method: str
    keys: Optional[torch.Tensor]     # int32[m] — redelivery addresses
    args: Any                        # the pre-exchange payload
    dropped: Optional[torch.Tensor]  # bool[m]
    # int32[3 + 2n]: (cross, dropped, delivered), then the per-destination
    # demand maxed over sources, then summed over sources
    stats: torch.Tensor
    inject_tick: int = -1
    measure_only: bool = False
    scale: int = 1


def resolve_rows_on_device(arena: GrainArena, keys: Any,
                           valid: torch.Tensor,
                           misses: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve grain keys to rows on the device: wide ``(hi, lo)`` keys,
    and int32 keys into an arena holding wide keys (the key ``k`` is the
    wide key ``(0, k)``), through the wide mirror (K10); other int32 keys
    with one gather from the dense direct map when the key space affords
    it (K1), else a binary search of the sorted mirror (K2).  An arena
    holding hot-grain replicas then spreads the rows (K18).  Returns
    (rows, miss count); the count adds into ``misses`` when given (a fused
    window's total)."""
    if isinstance(keys, tuple):
        hi, lo = keys
        rows, misses = resolve_wide(*arena.device_index_wide(), hi, lo,
                                    valid, misses)
    elif arena.has_wide_keys:
        # the narrow mirror cannot hold the arena's keys; keys at or above
        # the sentinel stay padding (K10's narrow mode), so a padding lane
        # never aliases a live grain whose key is 2**31 - 1
        rows, misses = resolve_wide(*arena.device_index_wide(), None, keys,
                                    valid, misses)
    else:
        dense = arena.dense_index()
        if dense is not None:
            rows, misses = resolve_dense(dense, keys, valid, misses)
        else:
            sorted_keys, sorted_rows = arena.device_index()
            rows, misses = resolve_sorted(sorted_keys, sorted_rows, keys,
                                          valid, misses)
    return _spread_resolved(arena, rows), misses


def _spread_resolved(arena: GrainArena, rows: torch.Tensor) -> torch.Tensor:
    """The hot-grain replica spread of resolved rows (K18) when the arena
    holds replicas; the rows as they are otherwise.  The mirror is the
    arena's cached device copy (row-keyed, so the spread composes with
    every key width)."""
    if not arena._replicas:
        return rows
    return spread_replicas(*arena.replica_mirror(), rows)


def _miss_keys(keys: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
               miss_buf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted unique unseen keys, padded with the sentinel to
    ``miss_buf`` (the smallest ``miss_buf`` when there are more), and the
    lane mask of the dropped messages (cold path only; K6)."""
    return miss_keys(keys, rows, valid, miss_buf)


def _park_copy(a: Any) -> Any:
    """A kept copy of a payload leaf or key tensor: a tensor is cloned on
    its stream (no sync), since the caller may rewrite it in place before
    the engine reads it; a JAX array cannot change, so the JAX package
    delivers the enqueue-time values.  Host leaves are kept as they are,
    as the JAX package keeps them."""
    return a.clone() if isinstance(a, torch.Tensor) else a


def _spill_copy(b: PendingBatch) -> PendingBatch:
    """A batch spilled past the round cap, with copies of every tensor it
    references (an emit can forward the loader's own payload tensor)."""
    return dataclasses.replace(
        b, args=_map_tree(_park_copy, b.args), rows=_park_copy(b.rows),
        keys_dev=_park_copy(b.keys_dev), mask=_park_copy(b.mask),
        keys_wide=_map_tree(_park_copy, b.keys_wide))


def _gather_lanes(a: Any, index: torch.Tensor) -> Any:
    """A payload leaf gathered by source lane: host scalars and 0-d
    tensors broadcast; arrays move to the index's device first."""
    a = _leaf_to_device(a, index.device)
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        return a
    if a.shape[0] == 0:  # no source lanes: every slot is invalid anyway
        return a.new_zeros((index.shape[0], *a.shape[1:]))
    return a.index_select(0, index)


def _host_take(a: Any, idx: np.ndarray) -> Any:
    """A payload leaf on the host, restricted to the lanes ``idx``
    (scalars broadcast)."""
    if isinstance(a, torch.Tensor):
        return a if a.dim() == 0 else a.cpu().numpy()[idx]
    return a if np.ndim(a) == 0 else np.asarray(a)[idx]


def _stack_counts(*xs: torch.Tensor) -> torch.Tensor:
    """Gather parked miss counters into one tensor, so the drain reads
    them all with one device→host copy."""
    return torch.stack(xs)


class IncrementalCollector:
    """Chunked, tick-interleaved activation collection under a pause
    budget: deactivation is a background cost, never a message-pump stall
    (reference: ActivationCollector.cs:37, Catalog.cs:836).

    A *sweep* selects every arena's idle victims once (K12 on the device,
    only the victim mask crosses to the host) and parks them as a work
    list.  *Slices* drain the list in ``collection_chunk_rows`` chunks
    between ticks, each slice capped at ``collection_pause_budget_s`` of
    host wall time; each chunk re-validates liveness and idleness before
    freeing, so rows touched since the sweep are spared.  Victims free
    only after their columnar write-back returns: a storage fault leaves
    them live for the retry (the next slice re-attempts; a synchronous
    ``drain`` raises)."""

    def __init__(self, engine: "TensorEngine") -> None:
        self.engine = engine
        # work list: [arena, cutoff, write_back, generation, rows]
        self._pending: deque = deque()
        self.sweeps_started = 0
        self.sweeps_completed = 0
        self.slices_run = 0
        self.rows_evicted = 0
        self.victims_dropped_stale = 0  # generation moved mid-sweep
        self.write_back_failures = 0
        self._last_write_error: Optional[BaseException] = None
        self.last_slices: deque = deque(maxlen=64)
        self.pause_seconds: deque = deque(maxlen=256)
        self.max_pause_s = 0.0

    def active(self) -> bool:
        return bool(self._pending)

    def pending_rows(self) -> int:
        return sum(len(e[4]) for e in self._pending)

    def start_sweep(self, cutoff: int, write_back: bool = True) -> int:
        """Select victims across all arenas and park them for sliced
        draining; a no-op while a sweep is still draining.  Returns the
        rows selected."""
        if self._pending:
            return 0
        selected = 0
        for arena in self.engine.arenas.values():
            victims = arena.select_idle_rows(cutoff)
            if len(victims):
                self._pending.append(
                    [arena, cutoff, write_back, arena.generation, victims])
                selected += len(victims)
        if selected:
            self.sweeps_started += 1
        return selected

    def run_slice(self, budget_s: float, chunk_rows: int) -> int:
        """Drain chunks until the pause budget is spent or the sweep is
        done; ``budget_s <= 0`` is unbounded (the synchronous baseline).
        Returns the rows evicted this slice."""
        if not self._pending:
            return 0
        t0 = time.perf_counter()
        chunk_rows = max(1, int(chunk_rows))
        freed = 0
        failed = False
        while self._pending:
            entry = self._pending[0]
            arena, cutoff, write_back, gen, rows = entry
            if arena.generation != gen:
                # rows moved since selection (growth, compaction): the ids
                # mean nothing now — drop the rest (counted); the next
                # sweep re-selects
                self.victims_dropped_stale += len(rows)
                self._pending.popleft()
                continue
            chunk, entry[4] = rows[:chunk_rows], rows[chunk_rows:]
            if len(entry[4]) == 0:
                self._pending.popleft()
            try:
                freed += arena.deactivate_idle_rows(chunk, cutoff,
                                                    write_back)
            except Exception as exc:  # noqa: BLE001 — a storage fault
                # must not kill the tick loop: nothing of this chunk was
                # freed (write-back precedes freeing), so park it back at
                # the front and retry next slice; drain() raises instead
                self.write_back_failures += 1
                self._last_write_error = exc
                if len(entry[4]):
                    entry[4] = np.concatenate([chunk, entry[4]])
                else:
                    entry[4] = chunk
                    self._pending.appendleft(entry)
                failed = True
                break
            if budget_s > 0 and time.perf_counter() - t0 >= budget_s:
                break
        dt = time.perf_counter() - t0
        self.slices_run += 1
        self.rows_evicted += freed
        self.pause_seconds.append(dt)
        self.max_pause_s = max(self.max_pause_s, dt)
        done = not self._pending
        if done:
            self.sweeps_completed += 1
        self.last_slices.append({
            "tick": self.engine.tick_number,
            "seconds": round(dt, 6),
            "evicted": freed,
            "remaining": self.pending_rows(),
            "sweep_done": done,
            "write_back_failed": failed,
        })
        return freed

    def drain(self, chunk_rows: int) -> int:
        """Finish the sweep in progress synchronously (explicit
        ``collect_idle``); a write-back failure raises here."""
        total = 0
        while self._pending:
            before = self.write_back_failures
            total += self.run_slice(0.0, chunk_rows)
            if self.write_back_failures > before:
                raise self._last_write_error
        return total

    def snapshot(self) -> Dict[str, Any]:
        return {
            "sweeps_started": self.sweeps_started,
            "sweeps_completed": self.sweeps_completed,
            "slices_run": self.slices_run,
            "rows_evicted": self.rows_evicted,
            "victims_dropped_stale": self.victims_dropped_stale,
            "pending_rows": self.pending_rows(),
            "write_back_failures": self.write_back_failures,
            "pause_p99_s": self.pause_p99_s(),
            "max_pause_s": self.max_pause_s,
            "last_slices": list(self.last_slices),
        }

    def pause_p99_s(self) -> float:
        """p99 over the recent slice pauses."""
        if not self.pause_seconds:
            return 0.0
        return float(np.percentile(np.asarray(self.pause_seconds), 99))


class TensorEngine:

    def __init__(self, config: Optional[TensorEngineConfig] = None,
                 initial_capacity: int = 1024,
                 device: Optional[Any] = None,
                 metrics: Optional[MetricsConfig] = None,
                 store: Optional[Any] = None,
                 snapshot_store: Optional[Any] = None,
                 silo: Optional[Any] = None,
                 mesh: Optional[ShardMesh] = None) -> None:
        from orleans_tpu_torch.tensor.autofuse import AutoFuser
        from orleans_tpu_torch.tensor.checkpoint import CheckpointPlane
        from orleans_tpu_torch.tensor.timers_plane import TimersPlane

        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"{mesh} lies off the engine's device "
                             f"{self.device}: every shard block lives on "
                             f"the engine's one card")
        # the owning silo of a clustered engine (None standalone); the
        # silo attaches its VectorRouter as ``router``
        self.silo = silo
        self.router = None
        self.config = config or TensorEngineConfig()
        self.metrics_config = metrics or MetricsConfig()
        # on-device latency ledger: per-(type, method) log2 histograms of
        # inject→completion tick deltas
        self.slot_registry = SlotRegistry()
        self.ledger = DeviceLatencyLedger(
            self.device, n_buckets=self.metrics_config.ledger_buckets,
            enabled=self.metrics_config.ledger_enabled,
            slots=self.slot_registry)
        # workload attribution: per-row traffic counts + count-min sketch
        # + per-method slots, folded in the dispatch phase and inside
        # fused windows; its slots index like the ledger's
        mc = self.metrics_config
        self.attribution = WorkloadAttribution(
            self, enabled=mc.attribution_enabled,
            top_k=mc.attribution_top_k, cms_depth=mc.attribution_cms_depth,
            cms_width=mc.attribution_cms_width, slots=self.slot_registry)
        self.initial_capacity = initial_capacity
        # VectorStore backing every arena (tensor/persistence.py):
        # activation reads, eviction write-back
        self.store = store
        self.arenas: Dict[str, GrainArena] = {}
        # incremental activation collection: sweeps select on the device,
        # slices drain between ticks under the pause budget
        self.collector = IncrementalCollector(self)
        self.queues: Dict[Tuple[str, str], List[PendingBatch]] = \
            defaultdict(list)
        self.tick_number = 0
        self._last_checkpoint_tick = 0
        self.rounds_run = 0
        self.messages_processed = 0
        self.activation_passes = 0
        # hot-grain replication (replicate_key / demote_key)
        self.replications = 0
        self.grains_replicated = 0
        self.replica_demotions = 0
        # migration: moves between shard blocks (migrate_keys) and the
        # cross-silo ring-change pushes and adoptions
        self.migrations = 0
        self.grains_migrated = 0
        # host-key batches the handoff fence deferred this tick (queued
        # again at the tick's end)
        self._fence_deferred: List[Tuple[Tuple[str, str], PendingBatch]] = []
        # recent per-tick durations → true latency percentiles
        self.tick_durations: deque = deque(maxlen=self.config.latency_window)
        # per-stage host wall time (reference: StageAnalysis.cs:81):
        # cumulative seconds per stage and the last unfused tick's split
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.last_tick_stages: Dict[str, float] = {}
        self._tick_stages: Dict[str, float] = defaultdict(float)
        self._step_cache: Dict[Tuple[str, str], Callable] = {}
        self._masks: Dict[int, torch.Tensor] = {}
        self._pending_checks: List[_MissCheck] = []
        # parked cross-shard exchange checks (drained with the miss checks)
        self._exchange_checks: List[_ExchangeCheck] = []
        # (src_type, src_method) → (DeviceFanout, dst_type, dst_method)
        self._fanouts: Dict[Tuple[str, str], Tuple[Any, str, str]] = {}
        self._fanout_checks: List[_FanoutCheck] = []
        # (src_type, src_method) → DeviceSubscriptions: the streams plane
        # (tensor/streams_plane.py) — stream-ingress messages fan out to
        # the streams' subscribers, pull-mode when the publish pattern is
        # the bound key set, push-mode otherwise
        self._stream_routes: Dict[Tuple[str, str], Any] = {}
        # completion fence of the latest step or fused window (a CUDA
        # event; None on CPU)
        self._tick_fence: Optional[torch.cuda.Event] = None
        # steady-state detection → fused windows
        self.autofuser = AutoFuser(self)
        # the device timers plane: a timing wheel over per-type slot
        # columns, harvested each unfused tick into batched
        # receive_reminder calls (config.timers_plane gates the harvest
        # only, so armed state survives a toggle)
        self.timers = TimersPlane(self)
        # the durable state plane: columnar checkpoints pinned at tick
        # boundaries, the device journal and crash recovery, engaged by a
        # SnapshotStore; _journal_sites is the ingress hook's O(1) test
        self.checkpointer = CheckpointPlane(self, snapshot_store)
        self._journal_sites: set = set()
        # the engine loop (start/stop)
        self._running = False
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        # shard blocks and the cross-shard exchange (tensor/mesh.py,
        # tensor/exchange.py); without a mesh one block, unless a caller
        # sets ``n_shards`` before the arenas exist (no exchange then)
        self._apply_mesh(mesh)

    # ================= arenas =============================================

    def _apply_mesh(self, mesh: Optional[ShardMesh]) -> None:
        """Adopt ``mesh``: its block count, the arenas' sharding marker,
        and — over more than one block — the exchange plane (built
        whenever blocks exist, so ``config.cross_shard_exchange`` can flip
        live; counters carry over from an earlier plane)."""
        self.mesh = mesh
        if mesh is not None:
            self.n_shards = mesh.n_shards
            self.sharding = BlockSharding(mesh, self.config.mesh_axis)
        else:
            self.n_shards = 1
            self.sharding = None
        self._check_durable_blocks()
        prev = getattr(self, "exchange", None)
        if mesh is not None and self.n_shards > 1:
            self.exchange = ShardExchange(self)
            self.exchange.adopt_stats(prev)
        else:
            self.exchange = None

    def _check_durable_blocks(self) -> None:
        if self.n_shards > 1 and self.checkpointer.enabled:
            raise NotImplementedError(
                f"a snapshot store over {self.n_shards} shard blocks "
                f"belongs to the next slice of the port (recovery points "
                f"of several blocks and migration pins across a cut; "
                f"ROADMAP queue A, item 7)")

    def _exchange_live(self) -> bool:
        """True when device batches route through the cross-shard exchange
        (a mesh of blocks and ``config.cross_shard_exchange``): the one
        predicate the unfused dispatch, the fused window and its rebuild
        check share."""
        return self.exchange is not None and \
            self.config.cross_shard_exchange

    def arena_for(self, type_name: str) -> GrainArena:
        arena = self.arenas.get(type_name)
        if arena is None:
            info = vector_type(type_name)
            if info is None:
                raise KeyError(f"{type_name!r} is not a @vector_grain type")
            self._check_durable_blocks()
            arena = GrainArena(info, self.device,
                               capacity=self.initial_capacity,
                               store=self.store, n_shards=self.n_shards,
                               sharding=self.sharding)
            arena.compact_fragmentation = \
                self.config.compact_fragmentation_threshold
            # row moves settle the auto-fuser's chain first
            arena._owner_engine = weakref.ref(self)
            self.arenas[type_name] = arena
        return arena

    def _streams_live(self) -> bool:
        """True when stream-subscription routes expand on the device
        (``config.stream_plane``); off = the host-expansion baseline.  The
        unfused dispatch and the fused window's rebuild check share it."""
        return bool(self.config.stream_plane)

    def _stream_routes_signature(self) -> Tuple:
        """What a fused window bakes of the stream routes: the registered
        routes and their layout and mutation versions (a rebuild allocates
        new layout tensors)."""
        return tuple((key, id(r), r.layout_version, r.mutation_version)
                     for key, r in sorted(self._stream_routes.items()))

    # ================= live migration =====================================

    def migrate_keys(self, type_name: str, keys: np.ndarray, dst_shards,
                     pin: bool = True) -> int:
        """Batched live migration of grains between shard blocks
        (``GrainArena.migrate_keys``): one K13 gather and one K3 SET per
        column move k grains' rows, the eviction epoch bumps so held rows
        re-validate, and ``pin`` keeps the move across an evict →
        reactivate cycle.  Parked miss, exchange and fan-out checks drain
        FIRST, so their redeliveries resolve against the moved rows.
        Returns the grains moved."""
        arena = self.arenas.get(type_name)
        if arena is None:
            return 0
        if self._pending_checks or self._exchange_checks \
                or self._fanout_checks:
            self._drain_checks()
        moved = arena.migrate_keys(keys, dst_shards, pin=pin)
        if moved:
            self.migrations += 1
            self.grains_migrated += moved
        return moved

    # ================= hot-grain replicas =================================

    def replicate_key(self, type_name: str, key: int, k: int) -> int:
        """Promote one hot grain to ``k`` replica rows
        (``GrainArena.promote_replicas``): delivery then scatters its lanes
        over the group by lane hash and reads see the fold.  Parked miss
        and fan-out checks drain FIRST, so their redeliveries resolve (and
        spread) against the new table.  Returns the group size (0 for an
        unknown type)."""
        arena = self.arenas.get(type_name)
        if arena is None:
            return 0
        if self._pending_checks or self._exchange_checks \
                or self._fanout_checks:
            self._drain_checks()
        if int(key) in arena._replicas:
            return len(arena._replicas[int(key)])
        got = arena.promote_replicas(key, k)
        self.replications += 1
        self.grains_replicated += 1
        return got

    def demote_key(self, type_name: str, key: int) -> int:
        """Fold a replicated grain back into one row
        (``GrainArena.demote_replicas``), after the same drain.  Returns
        the secondary rows freed."""
        arena = self.arenas.get(type_name)
        if arena is None:
            return 0
        if self._pending_checks or self._exchange_checks \
                or self._fanout_checks:
            self._drain_checks()
        freed = arena.demote_replicas(key)
        if freed:
            self.replica_demotions += 1
        return freed

    # ================= collection =========================================

    def collect_idle(self, max_idle_ticks: int,
                     write_back: bool = True) -> int:
        """Deactivate rows idle for > ``max_idle_ticks`` across all arenas
        and return the count: the explicit run-to-completion sweep
        (reference: ActivationCollector.cs:37).  A sweep in progress
        drains first; the tick loop drains the same pipeline in
        pause-budgeted slices instead."""
        chunk = self.config.collection_chunk_rows
        self.collector.drain(chunk)
        cutoff = self.tick_number - max_idle_ticks
        total = 0
        while True:
            # re-sweep until nothing is selected: a mid-drain threshold
            # compaction bumps the generation and drops the rest of that
            # sweep's victim ids, which are still idle
            if self.collector.start_sweep(cutoff,
                                          write_back=write_back) == 0:
                return total
            evicted = self.collector.drain(chunk)
            total += evicted
            if evicted == 0:
                return total

    # ================= checkpoints ========================================

    async def checkpoint(self) -> int:
        """Tick-consistent snapshot through the ``VectorStore``: quiesce,
        then write every live row of every arena.  Returns rows written."""
        await self.flush()
        return sum(a.checkpoint() for a in self.arenas.values())

    def maybe_periodic_checkpoint(self) -> float:
        """The bounded-loss-window write-back (``checkpoint_every_ticks``):
        fires once the tick clock has advanced past the cadence since the
        last write — at unfused tick boundaries and after fused windows,
        which advance the clock by whole windows.  Returns seconds spent
        (0.0 when it did not fire)."""
        if not self.checkpoint_due():
            return 0.0
        if self._exchange_checks and self._drain_exchange_checks():
            # exchange redeliveries just queued: their source updates have
            # not applied, but their fan-out deliveries may have — defer
            # the write one tick (checkpoint_due keeps firing until it
            # lands; the common no-drop drain proceeds)
            return 0.0
        t_cp = time.perf_counter()
        for a in self.arenas.values():
            if a.store is not None:
                a.checkpoint()
        self._last_checkpoint_tick = self.tick_number
        return time.perf_counter() - t_cp

    def checkpoint_due(self) -> bool:
        """True when the periodic write-back cadence has elapsed (shared
        with the auto-fuser, which verifies its chain before a due
        write)."""
        cadence = self.config.checkpoint_every_ticks
        return cadence > 0 and \
            self.tick_number - self._last_checkpoint_tick >= cadence

    def restore(self, type_names: Optional[List[str]] = None) -> int:
        """Re-activate every stored row (process-restart resume).  With no
        argument every registered vector-grain type is tried: arenas are
        created lazily, so a restarted engine's own arena dict is empty."""
        from orleans_tpu_torch.tensor.vector_grain import all_vector_types
        names = type_names if type_names is not None \
            else list(all_vector_types())
        return sum(self.arena_for(n).restore_from_store() for n in names)

    def register_journal(self, interface, method: str,
                         emit_key_args: Tuple[str, ...] = ()) -> None:
        """Mark (interface, method) as a journaled ingress site: every
        batch entering through ``send_batch`` or an injector appends to the
        device journal, seals into durable segments and fold-replays after
        a crash (``tensor/checkpoint.py``).  ``emit_key_args`` names arg
        leaves holding emit-destination keys of the same grain type (a
        transfer's ``dst``), which fused fold-replay activates first."""
        self.checkpointer.register_journal(interface, method,
                                           emit_key_args=emit_key_args)

    # ================= ingress ============================================

    @staticmethod
    def _type_name(interface) -> str:
        return interface if isinstance(interface, str) else interface.__name__

    def send_batch(self, interface, method: str, keys: Any, args: Any,
                   want_results: bool = False) -> Optional[asyncio.Future]:
        """Bulk message injection: one call carries a whole (keys,
        payload) slab.  int32 device keys resolve optimistically on the
        device; anything else resolves (and activates) on the host.  The
        batch keeps copies of the tensors it is given, taken now.

        On a clustered silo host-key batches route through the router:
        the local partition enqueues here, remote partitions ship as
        slabs to their ring owners.  Device-key batches stay local —
        remote keys surface as optimistic-resolution misses and ship at
        the next quiescence point (``_drain_checks``)."""
        type_name = self._type_name(interface)
        if self.router is not None:
            if (isinstance(keys, torch.Tensor) and keys.dtype == torch.int32
                    and not want_results):
                return self.enqueue_local_batch(type_name, method, keys,
                                                args)
            # everything else resolves eagerly on the host, which would
            # activate remote-owned keys locally — route instead
            if isinstance(keys, torch.Tensor):
                keys = keys.cpu().numpy()
            return self.router.route_batch(
                type_name, method, np.asarray(keys, dtype=np.int64), args,
                want_results=want_results)
        return self.enqueue_local_batch(type_name, method, keys, args,
                                        want_results=want_results)

    def enqueue_local_batch(self, type_name: str, method: str, keys: Any,
                            args: Any, want_results: bool = False
                            ) -> Optional[asyncio.Future]:
        """Queue a batch on THIS engine without ownership routing (the
        router calls this for partitions it has already proven local)."""
        future = asyncio.get_running_loop().create_future() \
            if want_results else None
        args = _map_tree(_park_copy, args)
        if (isinstance(keys, torch.Tensor) and keys.dtype == torch.int32
                and not want_results):
            # device keys resolve optimistically (unseen keys re-delivered
            # later), which cannot fix an already-resolved result future,
            # so want_results forces the host path
            batch = PendingBatch(args=args,
                                 keys_dev=keys.to(self.device, copy=True),
                                 inject_tick=self.tick_number)
        else:
            if isinstance(keys, torch.Tensor):
                keys = np.array(keys.cpu().numpy(), dtype=np.int64)
            batch = PendingBatch(args=args, future=future,
                                 keys_host=np.asarray(keys, dtype=np.int64),
                                 inject_tick=self.tick_number)
        if (type_name, method) in self._journal_sites:
            # write-ahead: journal the ingress before it can run
            self.checkpointer.journal_ingress(type_name, method, batch)
        self.queues[(type_name, method)].append(batch)
        self._wake_up()
        return future

    def register_fanout(self, src_interface, src_method: str, fanout,
                        dst_interface, dst_method: str) -> None:
        """Every message delivered to (src_interface, src_method) also
        expands through ``fanout`` (a ``DeviceFanout``) into messages for
        (dst_interface, dst_method), delivered the next round of the same
        tick (reference: ChirperAccount.PublishMessage → Followers loop,
        ChirperAccount.cs:129-156)."""
        self._fanouts[(self._type_name(src_interface), src_method)] = (
            fanout, self._type_name(dst_interface), dst_method)
        fanout.bind_owner(self)

    def register_subscriptions(self, src_interface, src_method: str,
                               subscriptions) -> None:
        """The streams plane's engine edge (``tensor/streams_plane.py``):
        every message delivered to (src_interface, src_method) — the
        stream-ingress method, rows = streams — also fans out to the
        stream's subscribers through ``subscriptions`` into its delivery
        edge.  Publishes of the bound key set take the pull path (one
        payload gather per edge, K16 in the subscriber's reductions);
        any other publish expands push-mode to subscriber keys (K11)."""
        self._stream_routes[(self._type_name(src_interface), src_method)] \
            = subscriptions

    def _route_expand_push(self, expander, dst_type: str, dst_method: str,
                           skeys: torch.Tensor, args: Any,
                           mask: Optional[torch.Tensor],
                           inject_tick: int) -> None:
        """Expand, queue the subscriber deliveries, and park the
        expansion's overflow mask with copies of the source keys and
        payload (dropped lanes expand again at the next drain)."""
        dst, gargs, valid = expander.expand(skeys, args, mask)
        count, dropped = expander.take_drop()
        self._fanout_checks.append(_FanoutCheck(
            expander=expander, dst_type=dst_type, dst_method=dst_method,
            keys=skeys.clone(), args=_map_tree(_park_copy, args),
            dropped=dropped, count=count, inject_tick=inject_tick))
        self.queues[(dst_type, dst_method)].append(
            PendingBatch(args=gargs, keys_dev=dst, mask=valid,
                         inject_tick=self.tick_number))
        if hasattr(expander, "push_deliveries"):
            expander.push_deliveries += 1

    def _run_fanout(self, type_name: str, method: str,
                    batches: List[PendingBatch]) -> None:
        """Expand the group's host-key batches (they resolve, activating,
        inside the group, so they expand before it).  Batches with device
        keys — emits, redeliveries, an injector's — expand after their
        resolution (``_expand_resolved_fanout``)."""
        fan = self._fanouts.get((type_name, method))
        if fan is None:
            return
        fanout, dst_type, dst_method = fan
        for b in batches:
            if b.no_fanout or b.keys_dev is not None:
                continue
            if b.keys_host is not None:
                if (b.keys_host >= KEY_SENTINEL).any() or \
                        (b.keys_host < 0).any():
                    raise OverflowError(
                        "fanout src keys must be in [0, 2**31-1)")
                skeys = host_upload(b.keys_host.astype(np.int32), self.device)
            elif b.keys_wide is not None:
                raise OverflowError(
                    "fanout expansion requires narrow int keys in "
                    "[0, 2**31-1); wide (hi, lo) source keys cannot map "
                    "through the CSR subscription graph")
            else:
                continue  # a row-only batch: no keys to expand
            self._route_expand_push(fanout, dst_type, dst_method, skeys,
                                    b.args, b.mask, b.inject_tick)

    def _expand_resolved_fanout(self, fan, batches: List[PendingBatch],
                                resolved: List[Tuple[Any, Any]]) -> None:
        """Device-key fan-out, gated by the resolution the step applies:
        lanes that hit expand now, missed lanes when their redelivery
        applies."""
        fanout, dst_type, dst_method = fan
        for b, (rows, _args) in zip(batches, resolved):
            if b.no_fanout or b.keys_dev is None:
                continue
            if isinstance(rows, np.ndarray):  # a stale injector's rows
                rows = host_upload(rows, self.device)
            base = b.mask if b.mask is not None \
                else self._mask_for(len(b))
            self._route_expand_push(fanout, dst_type, dst_method,
                                    b.keys_dev, b.args, base & (rows >= 0),
                                    b.inject_tick)

    # -- stream-subscription routes (tensor/streams_plane.py) ---------------

    def _to_host_batch(self, b: PendingBatch) -> PendingBatch:
        """A device-key batch as a host-key batch (the plane-disabled
        baseline pays the device→host copy; masked lanes are dropped on
        the host — host-key batches carry no mask)."""
        if b.keys_host is not None and b.mask is None:
            return b
        keys = b.keys_host if b.keys_host is not None \
            else b.keys_dev.cpu().numpy().astype(np.int64)
        args = _map_tree(lambda a: a if np.ndim(a) == 0 else _host_array(a),
                         b.args)
        if b.mask is not None:
            sel = b.mask.cpu().numpy()
            keys = keys[sel]
            args = _map_tree(lambda a: a if np.ndim(a) == 0 else a[sel], args)
        return PendingBatch(args=args, keys_host=keys, no_fanout=b.no_fanout,
                            inject_tick=b.inject_tick)

    def _run_stream_routes_pre(self, type_name: str, method: str,
                               batches: List[PendingBatch]
                               ) -> List[PendingBatch]:
        """The pre-resolution half of a stream route: host-key publishes
        expand here (they activate inside the group), device-key publishes
        after resolution.  With the plane off this is the HOST baseline:
        publishes become host batches and the adjacency walks in numpy."""
        route = self._stream_routes.get((type_name, method))
        if route is None:
            return batches

        def expand_on_host(b2: PendingBatch) -> None:
            route.published_events += len(b2)
            dst_keys, src_idx = route.host_expand(b2.keys_host)
            if len(dst_keys) == 0:
                return
            gargs = _map_tree(lambda a: a if np.ndim(a) == 0
                              else _host_array(a)[src_idx], b2.args)
            if isinstance(gargs, dict) and "src_key" not in gargs:
                gargs = {**gargs,
                         "src_key": (b2.keys_host[src_idx]
                                     % np.int64(KEY_SENTINEL))
                         .astype(np.int32)}
            self.queues[(route.type_name, route.method)].append(
                PendingBatch(args=gargs, keys_host=dst_keys.astype(np.int64),
                             inject_tick=self.tick_number))
            route.delivered_events += len(dst_keys)

        if not self._streams_live():
            out: List[PendingBatch] = []
            for b in batches:
                if b.no_fanout or (b.keys_host is None
                                   and b.keys_dev is None):
                    out.append(b)
                    continue
                b2 = self._to_host_batch(b)
                out.append(b2)
                expand_on_host(b2)
            return out
        for b in batches:
            if b.no_fanout or b.keys_dev is not None \
                    or b.keys_host is None:
                continue  # device-key publishes expand post-resolve
            if (b.keys_host >= KEY_SENTINEL).any() \
                    or (b.keys_host < 0).any():
                # wide stream keys: the device CSR is int31-keyed — expand
                # on the host instead of failing mid-tick
                expand_on_host(b)
                continue
            route.published_events += len(b)
            self._route_expand_push(
                route, route.type_name, route.method,
                host_upload(b.keys_host.astype(np.int32), self.device),
                b.args, b.mask, b.inject_tick)
        return batches

    def _expand_resolved_stream_routes(self, route,
                                       batches: List[PendingBatch],
                                       resolved: List[Tuple[Any, Any]]
                                       ) -> None:
        """Device-key publishes, gated by the resolution the step applies.
        A publish of the route's BOUND key set takes the pull path: the
        deliveries queue as ONE row-addressed batch with segment offsets
        (the payload gathered per edge; nothing to resolve, no scatter
        downstream).  Any other publish expands push-mode to keys."""
        dst_arena = self.arena_for(route.type_name)
        for b, (rows, _args) in zip(batches, resolved):
            if b.no_fanout or b.keys_dev is None \
                    or b.segments is not None:
                continue
            if isinstance(rows, np.ndarray):  # a stale injector's rows
                rows = host_upload(rows, self.device)
            base = b.mask if b.mask is not None \
                else self._mask_for(len(b))
            gate = base & (rows >= 0)
            route.published_events += len(b)
            pull = route.pull_layout(dst_arena) \
                if route._matches_bound(b.keys_host) else None
            if pull is not None and pull["n_edges"] > 0:
                lane = pull["src_lane"]
                gargs = _map_tree(lambda a: _gather_lanes(a, lane), b.args)
                if isinstance(gargs, dict) and "src_key" not in gargs:
                    gargs = {**gargs, "src_key": pull["src_key"]}
                self.queues[(route.type_name, route.method)].append(
                    PendingBatch(
                        args=gargs, rows=pull["rows"],
                        keys_dev=pull["dst_key"],
                        mask=gate.index_select(0, lane),
                        segments=pull["offsets"],
                        generation=dst_arena.generation,
                        epoch=dst_arena.eviction_epoch,
                        inject_tick=self.tick_number))
                route.pull_deliveries += 1
                route.delivered_events += pull["n_edges"]
            else:
                self._route_expand_push(
                    route, route.type_name, route.method, b.keys_dev,
                    b.args, gate, b.inject_tick)

    def make_injector(self, interface, method: str, keys: np.ndarray):
        """Pre-resolve a stable destination set once; later injections
        reuse the device row vector (the steady-state client edge).  On a
        clustered silo the split by ring owner is part of what is
        resolved once (``router.make_injector`` → ``ClusterInjector``)."""
        type_name = self._type_name(interface)
        keys = np.asarray(keys, dtype=np.int64)
        if self.router is not None:
            return self.router.make_injector(type_name, method, keys)
        return BatchInjector(self, type_name, method, keys)

    def fuse_ticks(self, interface, method: str, keys: np.ndarray):
        """The steady-state tick of (interface, method) over a fixed key
        set as one multi-tick program (``tensor/fused.py``): its
        ``run(stacked_args, static_args)`` executes a whole [T, ...]
        window, and ``verify()`` must report 0 misses for it to be
        exact.  On a clustered silo the key set must be ring-owned here:
        a fused window is a one-engine program (fuse each silo's own
        partition; cross-silo traffic rides the slab path)."""
        from orleans_tpu_torch.tensor.fused import FusedTickProgram

        type_name = self._type_name(interface)
        keys = np.asarray(keys, dtype=np.int64)
        if self.router is not None:
            local_mask, remote = self.router.partition(type_name, keys)
            if remote:
                raise ValueError(
                    f"fuse_ticks({type_name}): {int((~local_mask).sum())} "
                    f"of {len(keys)} keys are ring-owned by other silos; "
                    "a fused window would activate them locally (duplicate "
                    "activation). Fuse only keys[local] per silo — "
                    "partition with silo.vector_router.partition().")
        return FusedTickProgram(self, type_name, method, keys)

    def send_one(self, grain_id, method, args: tuple
                 ) -> Optional[asyncio.Future]:
        """Single-message path (a vector grain's per-message call): a
        one-lane batch through ``send_batch``; the future resolves to the
        lane's result."""
        info = vector_type(grain_id.type_code)
        if info is None:
            raise KeyError(f"{grain_id} is not a vector grain")
        payload = args[0] if args else {}
        one = _map_tree(lambda x: np.asarray([x]), payload)
        fut = self.send_batch(info.name, method.name,
                              np.array([grain_id.primary_key_int]), one,
                              want_results=not method.one_way)
        if fut is None:
            return None
        scalar = asyncio.get_running_loop().create_future()

        def unwrap(f: asyncio.Future) -> None:
            if scalar.done():
                return
            if f.exception() is not None:
                scalar.set_exception(f.exception())
            else:
                res = f.result()
                scalar.set_result(
                    _map_tree(lambda x: np.asarray(x)[0], res)
                    if res is not None else None)

        fut.add_done_callback(unwrap)
        return scalar

    # ================= tick loop ==========================================

    def start(self) -> None:
        """Run ticks in a task of the current event loop whenever work is
        queued (``stop`` ends it)."""
        self._running = True
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self, drain: bool = True) -> None:
        if drain and self._running:
            await self.flush()
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    def _wake_up(self) -> None:
        if self._wake is not None:
            self._wake.set()

    def halt(self) -> None:
        """End the engine loop at once, queued work dropped (a silo's
        hard kill)."""
        self._running = False
        self._wake_up()

    async def _loop(self) -> None:
        while self._running:
            await self._wake.wait()
            self._wake.clear()
            while self._running:
                while self._running and any(self.queues.values()):
                    self.run_tick()
                    await asyncio.sleep(LOOP_TICK_SECONDS)
                if self._drain_checks():
                    continue
                if self._running and self.autofuser.has_buffer():
                    # a partially filled fused window and no new work:
                    # give the producer one grace period to continue the
                    # pattern, then replay the buffer unfused so buffered
                    # ticks never strand awaiting an explicit flush()
                    try:
                        await asyncio.wait_for(
                            self._wake.wait(),
                            timeout=self.config.auto_fusion_idle_flush)
                        self._wake.clear()
                        continue
                    except asyncio.TimeoutError:
                        self.autofuser.idle_flush()
                        continue
                break

    # ================= tick execution =====================================

    async def drain_queues(self) -> None:
        """Run ticks until every queue is empty, without settling deferred
        miss-checks (the pipelined steady-state path)."""
        while any(self.queues.values()):
            self.run_tick()
            if self.router is not None \
                    and not self.router.handoff_settled():
                # the handoff fence is re-queueing unseen-key batches —
                # pace the retries for the fence window
                await asyncio.sleep(0.002)
            else:
                await asyncio.sleep(0)

    async def flush(self) -> None:
        """Run ticks until every queue drains AND every optimistic
        miss-check and fan-out check has settled (full delivery).  A
        partially filled fused window replays unfused here, one buffered
        tick at a time."""
        while True:
            await self.drain_queues()
            requeued = self._drain_checks()
            if self.autofuser.flush_partial():
                requeued = True
            if not requeued:
                if self.router is not None and self.router._retry_tasks:
                    # parked cross-silo redelivery (over-forwarded slabs
                    # awaiting backoff) is in-flight work; the retry
                    # budget bounds this wait
                    await asyncio.sleep(0.01)
                    continue
                break
            if self.router is not None \
                    and not self.router.handoff_settled():
                # the fence is deferring unseen-key activation — pace the
                # retry loop while awaiting peers' releases
                await asyncio.sleep(0.005)
        # fold un-taken expansion drops (direct expand() users) into the
        # fan-outs' and stream routes' host stats
        for fanout, _, _ in self._fanouts.values():
            fanout.overflow_check()
        for route in self._stream_routes.values():
            route.overflow_check()

    def wait_completion(self) -> None:
        """Block until the latest step has completed on the device."""
        if self._tick_fence is not None:
            self._tick_fence.synchronize()

    def run_tick(self) -> None:
        if self.autofuser.offer():
            # the tick was consumed into (or ran as part of) a fused
            # window — counters and latency are accounted by the window
            return
        t0 = time.perf_counter()
        self.tick_number += 1
        stages = self._tick_stages = defaultdict(float)
        cfg = self.config
        if cfg.collection_idle_ticks and cfg.collection_every_ticks > 0:
            # incremental collection: the cadence tick selects victims
            # (K12, mask-only transfer); every tick then drains one
            # pause-budgeted slice until the sweep finishes
            if (not self.collector.active()
                    and self.tick_number % cfg.collection_every_ticks == 0):
                self.collector.start_sweep(
                    self.tick_number - cfg.collection_idle_ticks)
            if self.collector.active():
                self.collector.run_slice(cfg.collection_pause_budget_s,
                                         cfg.collection_chunk_rows)
                stages["collect"] += time.perf_counter() - t0
        if cfg.timers_plane and self.timers.armed_total:
            # harvest due timers BEFORE the rounds, so fired batches
            # deliver within this tick
            dt_tm = self.timers.advance_to(self.tick_number)
            if dt_tm:
                stages["timers"] += dt_tm
        if len(self._pending_checks) + len(self._exchange_checks) \
                + len(self._fanout_checks) >= self.config.miss_check_cap:
            # bound device memory pinned by parked checks (exchange and
            # fan-out checks pin their batch's payload the same way)
            self._drain_checks()
        rounds = 0
        while rounds < self.config.max_rounds_per_tick:
            pending = {k: v for k, v in self.queues.items() if v}
            if not pending:
                break
            self.queues = defaultdict(list)
            if self._exchange_live() and self.config.exchange_overlap \
                    and self.router is None and self.exchange.engaged():
                self._pre_exchange_round(pending, stages)
            for (type_name, method), batches in pending.items():
                tf = time.perf_counter()
                if self.router is not None:
                    # ownership + handoff fence BEFORE fan-out: shipped and
                    # fence-deferred batches must not expand their
                    # subscriber deliveries here this tick
                    batches = self._route_group(type_name, method, batches)
                    if not batches:
                        stages["fanout"] += time.perf_counter() - tf
                        continue
                self._run_fanout(type_name, method, batches)
                batches = self._run_stream_routes_pre(type_name, method,
                                                      batches)
                stages["fanout"] += time.perf_counter() - tf
                self._run_group(type_name, method, batches)
            rounds += 1
            self.rounds_run += 1
        for batches in self.queues.values():
            # round-cap spill: these run next tick, after the caller may
            # have rewritten the tensors they reference
            batches[:] = [_spill_copy(b) for b in batches]
        if self._fence_deferred:
            for qkey, b in self._fence_deferred:
                self.queues[qkey].append(b)
            self._fence_deferred = []
        t_cp = self.maybe_periodic_checkpoint()
        if t_cp:
            stages["checkpoint"] += t_cp
        # the durable state plane: start or advance a due snapshot under
        # its pause budget, keep the journal's seal cadence
        t_ck = self.checkpointer.on_tick()
        if t_ck:
            stages["checkpoint"] += t_ck
        dt = time.perf_counter() - t0
        for k, v in stages.items():
            self.stage_seconds[k] += v
        self.last_tick_stages = dict(stages)
        self.tick_durations.append(dt)

    def stats(self) -> Dict[str, Any]:
        """Engine counters: the keys of ``orleans_tpu``'s
        ``TensorEngine.snapshot()`` that the port has.  Host-side only —
        the ledger's bucket counts come from ``ledger.snapshot()``, which
        pays its one device→host copy explicitly."""
        return {
            "ticks": self.tick_number,
            "rounds": self.rounds_run,
            "messages": self.messages_processed,
            "activation_passes": self.activation_passes,
            "stages": dict(self.stage_seconds),
            "last_tick_stages": dict(self.last_tick_stages),
            "tick_latency": self.latency_stats(),
            "autofuse": self.autofuser.snapshot(),
            "arenas": {name: a.live_count for name, a in self.arenas.items()},
            "evicted": sum(a.evicted_count for a in self.arenas.values()),
            "restored": sum(a.restored_count for a in self.arenas.values()),
            # hot-grain replication (replicate_key / demote_key)
            "replications": self.replications,
            "grains_replicated": self.grains_replicated,
            "replica_demotions": self.replica_demotions,
            "replica_folds": sum(a.replica_folds
                                 for a in self.arenas.values()),
            "replicated_now": sum(len(a._replicas)
                                  for a in self.arenas.values()),
            "collection": self.collector.snapshot(),
            "fragmentation": {name: round(a.fragmentation(), 4)
                              for name, a in self.arenas.items()},
            "latency_ledger": self.ledger.stats(),
            "attribution": self.attribution.stats(),
            # armed/fired counters, harvest width and lateness (host
            # mirrors only)
            "timers": self.timers.snapshot(),
            # the streams plane's routes ({} when none is registered)
            "streams": {f"{t}.{m}": r.snapshot()
                        for (t, m), r in self._stream_routes.items()},
            # checkpoint and journal health, the recovery-point age
            "durability": self.checkpointer.snapshot(),
            # live migration between shard blocks (migrate_keys)
            "migrations": self.migrations,
            "grains_migrated": self.grains_migrated,
            # the cross-shard exchange (None without shard blocks)
            "exchange": self.exchange.snapshot()
            if self.exchange is not None else None,
        }

    def latency_stats(self) -> Dict[str, float]:
        """True percentiles over the recent per-tick duration window."""
        if not self.tick_durations:
            return {"n": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                    "mean": 0.0, "max": 0.0}
        d = np.asarray(self.tick_durations)
        return {
            "n": int(d.size),
            "p50": float(np.percentile(d, 50)),
            "p90": float(np.percentile(d, 90)),
            "p99": float(np.percentile(d, 99)),
            "mean": float(d.mean()),
            "max": float(d.max()),
        }

    # -- destination resolution --------------------------------------------

    def _mask_for(self, n: int) -> torch.Tensor:
        m = self._masks.get(n)
        if m is None:
            if len(self._masks) >= 256:
                self._masks.clear()
            m = self._masks[n] = ones_mask(n, self.device)
        return m

    def _resolve_batch(self, arena: GrainArena, b: PendingBatch,
                       method: str) -> Tuple[Any, Any]:
        """Normalize a batch to (rows, args): device rows for the injector
        fast path and for device keys, numpy rows for host keys.

        Device keys resolve *optimistically*: messages to unseen keys get
        row -1 (dropped by the kernels) and a miss-check is parked; at the
        next drain the engine activates the unseen keys and delivers
        exactly the dropped messages again (reference: CallbackData
        resend, Dispatcher rerouting)."""
        if b.rows is not None and b.generation == arena.generation \
                and b.epoch == arena.eviction_epoch:
            return b.rows, b.args
        if b.keys_host is not None:
            # stale pre-resolved rows fall through to here too: a
            # generation change moved rows, an epoch change freed some;
            # host resolution re-activates an evicted key (from the store)
            rows = arena.spread_rows_host(
                arena.resolve_rows(b.keys_host, tick=self.tick_number))
            return rows.astype(np.int32), b.args
        keys = b.keys_wide if b.keys_wide is not None else b.keys_dev
        valid = b.mask if b.mask is not None else self._mask_for(len(b))
        rows, miss_count = resolve_rows_on_device(arena, keys, valid)
        self._pending_checks.append(
            _MissCheck(arena=arena, type_name=arena.info.name, method=method,
                       keys=_map_tree(_park_copy, keys), valid=valid.clone(),
                       rows=rows, miss_count=miss_count,
                       args=_map_tree(_park_copy, b.args),
                       inject_tick=b.inject_tick))
        return rows, b.args

    def _drain_checks(self) -> bool:
        """Quiescence point: activate the unseen keys found by optimistic
        resolution and queue their (and only their) messages again.
        Returns True if work was queued."""
        if not self._pending_checks and not self._exchange_checks \
                and not self._fanout_checks:
            return False
        checks = self._pending_checks
        self._pending_checks = []
        requeued = self._drain_exchange_checks()
        if self._drain_fanout_checks():
            requeued = True
        if not checks:
            return requeued
        # one device→host copy for every parked count
        counts = _stack_counts(*(c.miss_count for c in checks)).tolist()
        for c, cnt in zip(checks, counts):
            if cnt == 0:
                continue
            self.activation_passes += 1
            if isinstance(c.keys, tuple):
                # wide keys: the missed lanes go again through the exact
                # host path (their int64 keys rejoined), which activates
                # and cannot loop on a collision run the probes miss; their
                # fan-out, if any, already expanded
                idx = np.nonzero(((c.rows < 0) & c.valid).cpu().numpy())[0]
                if len(idx) == 0:
                    continue
                keys64 = join_wide_keys(c.keys[0].cpu().numpy()[idx],
                                        c.keys[1].cpu().numpy()[idx])
                self.queues[(c.type_name, c.method)].append(PendingBatch(
                    args=_map_tree(lambda a: _host_take(a, idx), c.args),
                    keys_host=keys64, no_fanout=True,
                    inject_tick=c.inject_tick))
                requeued = True
                continue
            miss_keys, missing = _miss_keys(c.keys, c.rows, c.valid, MISS_BUF)
            mk = miss_keys.cpu().numpy()
            mk = mk[mk != KEY_SENTINEL].astype(np.int64)
            if self.router is not None and len(mk):
                # single activation across silos: a miss key owned by a
                # remote silo must NOT activate here — its messages ship
                # to the owner as one slab per destination
                local_mask, remote = self.router.partition(c.type_name, mk)
                if remote:
                    keys_np = c.keys.cpu().numpy()
                    missing_np = missing.cpu().numpy().copy()
                    args_h = _map_tree(
                        lambda a: a.cpu().numpy()
                        if isinstance(a, torch.Tensor) and a.dim() else a,
                        c.args)
                    shipped = np.zeros(len(keys_np), dtype=bool)
                    for target, ridx in remote.items():
                        sel = missing_np & np.isin(
                            keys_np, mk[ridx].astype(keys_np.dtype))
                        if not sel.any():
                            continue
                        sidx = np.nonzero(sel)[0]
                        self.router.ship_slab(
                            target, c.type_name, c.method,
                            keys_np[sidx].astype(np.int64),
                            _map_tree(lambda a: _host_take(a, sidx),
                                      args_h))
                        shipped |= sel
                    mk = mk[local_mask]
                    missing_np &= ~shipped
                    if len(mk) == 0 and not missing_np.any():
                        continue  # whole batch shipped — nothing local left
                    missing = torch.from_numpy(missing_np).to(self.device)
            if len(mk) and self.router is not None \
                    and not self.router.handoff_settled():
                # handoff fence: activating these unseen keys could read
                # the store before the previous owner's write-back lands —
                # requeue and retry once peers release (or time out).
                # no_fanout while fenced: every masked lane is known
                # unresolvable; the post-settle requeue expands again.
                self.queues[(c.type_name, c.method)].append(PendingBatch(
                    args=c.args, keys_dev=c.keys, mask=missing,
                    no_fanout=True, inject_tick=c.inject_tick))
                requeued = True
                continue
            if len(mk):
                c.arena.resolve_rows(mk, tick=self.tick_number)  # activates
            # re-deliver only the dropped messages; converges over passes
            # when the unique misses exceed MISS_BUF
            self.queues[(c.type_name, c.method)].append(PendingBatch(
                args=c.args, keys_dev=c.keys, mask=missing,
                inject_tick=c.inject_tick))
            requeued = True
        return requeued

    def _pre_exchange_round(self, pending, stages) -> None:
        """Exchange overlap, unfused path: at round start, run the exchange
        of every queued single batch whose rows are already cached (the
        injector path).  The exchange reads no arena state, so moving it
        ahead is exact; its group uses the result only while the stamps
        and the rows identity still match, else it runs the exchange
        again inline.  A clustered silo skips this (a batch may ship to
        another silo before it runs)."""
        t0 = time.perf_counter()
        did = False
        for (type_name, method), batches in pending.items():
            if len(batches) != 1:
                continue
            b = batches[0]
            if (b.future is not None or b.keys_dev is None
                    or b.keys_wide is not None or b.rows is None
                    or b.segments is not None
                    or b.pre_exchange is not None):
                continue
            arena = self.arenas.get(type_name)
            if arena is None or arena.sharding is None:
                continue
            if b.generation != arena.generation \
                    or b.epoch != arena.eviction_epoch:
                continue
            if not exchangeable_args(b.args, len(b)):
                continue
            base = b.mask if b.mask is not None else self._mask_for(len(b))
            args = _map_tree(lambda a: _leaf_to_device(a, self.device),
                             b.args)
            r2, a2, m2, dropped, stats, run_cost = self.exchange.dispatch(
                arena, b.rows, args, base, site=(type_name, method),
                defer_stats=True)
            b.pre_exchange = (r2, a2, m2, dropped, stats, arena.generation,
                              arena.eviction_epoch, b.rows,
                              time.perf_counter(), run_cost)
            did = True
        if did:
            stages["exchange"] += time.perf_counter() - t0

    def _drain_exchange_checks(self) -> bool:
        """The exchange's half of the drain: fold every parked stats vector
        (one device→host copy for all of them) and queue the dropped lanes
        again by key, with their original inject stamps.  Returns True if
        redeliveries were queued."""
        if not self._exchange_checks:
            return False
        checks = self._exchange_checks
        self._exchange_checks = []
        stats = _stack_counts(*(c.stats for c in checks)).cpu().numpy()
        xch = self.exchange
        requeued = False
        for c, row in zip(checks, stats):
            if xch is not None:
                # the demand tail sizes this site's future caps
                xch.fold_stats(row, site=(c.type_name, c.method),
                               scale=c.scale)
            if c.measure_only or int(row[1]) == 0:
                continue
            if xch is not None:
                xch.redeliveries += 1
            # no_fanout: the first pass already expanded the subscriber
            # deliveries of these lanes (they resolved; the drop happened
            # in the bucket)
            self.queues[(c.type_name, c.method)].append(PendingBatch(
                args=c.args, keys_dev=c.keys, mask=c.dropped,
                no_fanout=True, inject_tick=c.inject_tick))
            requeued = True
        return requeued

    def _drain_fanout_checks(self) -> bool:
        """Fold the parked fan-out drop counts (one device→host copy for
        all) and expand exactly the dropped source lanes again, their
        deliveries stamped with the original inject tick.  Each pass
        completes at least one parked lane (the width is never below one
        lane's degree), so the drains converge.  Returns True if
        deliveries were queued."""
        if not self._fanout_checks:
            return False
        checks = self._fanout_checks
        self._fanout_checks = []
        counts = _stack_counts(*(c.count for c in checks)).tolist()
        requeued = False
        for c, cnt in zip(checks, counts):
            exp = c.expander
            exp.dropped_lanes += int(cnt)
            if cnt == 0:
                continue
            exp.redeliveries += 1
            dst, gargs, valid = exp.expand(c.keys, c.args, c.dropped)
            cnt2, dropped2 = exp.take_drop()
            self._fanout_checks.append(dataclasses.replace(
                c, dropped=dropped2, count=cnt2))
            self.queues[(c.dst_type, c.dst_method)].append(PendingBatch(
                args=gargs, keys_dev=dst, mask=valid,
                inject_tick=c.inject_tick))
            requeued = True
        return requeued

    # -- group execution ----------------------------------------------------

    @staticmethod
    def _coalesce_host_batches(batches: List[PendingBatch]
                               ) -> List[PendingBatch]:
        """Merge consecutive runs of plain host-key batches (no cached
        rows, futures or masks) into one batch, keeping FIFO order against
        the batches that cannot merge."""

        def mergeable(b: PendingBatch) -> bool:
            return (b.future is None and b.keys_host is not None
                    and b.rows is None and b.keys_dev is None
                    and b.mask is None and not b.no_fanout)

        def merge(member: List[PendingBatch]) -> PendingBatch:
            def cat(*leaves):
                return np.concatenate(
                    [np.broadcast_to(_host_array(x),
                                     (len(member[i].keys_host),)
                                     + np.shape(x)[1:])
                     if np.ndim(x) == 0 else _host_array(x)
                     for i, x in enumerate(leaves)])

            return PendingBatch(
                args=_map_trees(cat, *(b.args for b in member)),
                keys_host=np.concatenate([b.keys_host for b in member]))

        out: List[PendingBatch] = []
        r = 0
        while r < len(batches):
            if not mergeable(batches[r]):
                out.append(batches[r])
                r += 1
                continue
            end = r
            while end < len(batches) and mergeable(batches[end]):
                end += 1
            run = batches[r:end]
            out.append(run[0] if len(run) == 1 else merge(run))
            r = end
        return out

    def _concat_resolved(self, batches: List[PendingBatch],
                         resolved: List[Tuple[Any, Any]]) -> Tuple[Any, ...]:
        """One device batch from several (rare: fan-in of emits from
        several producer groups); scalar leaves broadcast to their lanes."""
        dev = self.device
        rows = torch.cat([_leaf_to_device(np.asarray(r), dev)
                          if isinstance(r, np.ndarray) else r
                          for r, _ in resolved])

        def cat(*leaves):
            parts = []
            for (r, _), x in zip(resolved, leaves):
                t = _leaf_to_device(x, dev)
                if not isinstance(t, torch.Tensor):  # a host scalar
                    t = torch.as_tensor(_host_array(x), device=dev)
                parts.append(t.expand(len(r)) if t.dim() == 0 else t)
            return torch.cat(parts)

        args = _map_trees(cat, *(a for _, a in resolved))
        masks = [b.mask for b in batches]
        mask = None if all(m is None for m in masks) else torch.cat(
            [m if m is not None else self._mask_for(len(b))
             for m, b in zip(masks, batches)])
        return rows, args, mask

    def _filter_ownership(self, type_name: str, method: str,
                          batches: List[PendingBatch]
                          ) -> List[PendingBatch]:
        """Resolve-time ownership re-check for host-key batches.

        Ownership proven at enqueue time can be stale at drain time (a
        ring change between the two evicts the keys by handoff); blindly
        re-resolving would activate them here while the new owner also
        activates them.  Strays found now are shipped (or, for a batch
        with a result future, the whole batch is routed again and its
        future chained).  One-member rings short-circuit inside
        ``partition``."""
        arena = self.arenas.get(type_name)
        gen = arena.generation if arena is not None else -1
        epoch = arena.eviction_epoch if arena is not None else -1
        out: List[PendingBatch] = []
        for b in batches:
            if b.keys_host is None:
                out.append(b)  # device keys: the miss path owns routing
                continue
            if b.rows is not None and b.generation == gen \
                    and b.epoch == epoch:
                # injector fast path: the handoff evicts strays by bumping
                # the epoch, so still-valid rows imply still-owned keys
                out.append(b)
                continue
            local_mask, remote = self.router.partition(type_name,
                                                       b.keys_host)
            if not remote:
                out.append(b)
                continue
            if b.future is not None:
                # results are positional over the whole batch
                routed = self.router.route_batch(
                    type_name, method, b.keys_host, b.args,
                    want_results=True)

                def relay(f: asyncio.Future, dst=b.future) -> None:
                    if dst.done():
                        return
                    if f.exception() is not None:
                        dst.set_exception(f.exception())
                    else:
                        dst.set_result(f.result())

                routed.add_done_callback(relay)
                continue
            args_h = _map_tree(
                lambda a: a.cpu().numpy()
                if isinstance(a, torch.Tensor) and a.dim() else a, b.args)
            for target, ridx in remote.items():
                self.router.ship_slab(
                    target, type_name, method, b.keys_host[ridx],
                    _map_tree(lambda a: _host_take(a, ridx), args_h))
            lidx = np.nonzero(local_mask)[0]
            if len(lidx):
                out.append(PendingBatch(
                    args=_map_tree(lambda a: _host_take(a, lidx), args_h),
                    keys_host=b.keys_host[lidx], no_fanout=b.no_fanout,
                    inject_tick=b.inject_tick))
        return out

    def _route_group(self, type_name: str, method: str,
                     batches: List[PendingBatch]) -> List[PendingBatch]:
        """Clustered pre-pass of one (type, method) group, run before
        fan-out expansion: ship non-owned partitions (the ownership
        re-check) and park fence-deferred batches.  A batch the handoff
        fence defers defers with its fan-out unexpanded, so the source
        update and its subscriber deliveries land in the same later
        tick."""
        arena = self.arena_for(type_name)
        batches = self._filter_ownership(type_name, method, batches)
        if batches and not self.router.handoff_settled():
            # host-key batches touching unseen keys would activate them
            # from the store, racing the previous owner's write-back
            safe: List[PendingBatch] = []
            for b in batches:
                if b.keys_host is not None and (
                        b.rows is None or b.generation != arena.generation
                        or b.epoch != arena.eviction_epoch):
                    _, found = arena.lookup_rows(b.keys_host)
                    if not found.all():
                        self._fence_deferred.append(((type_name, method), b))
                        continue
                safe.append(b)
            batches = safe
        return batches

    def _run_group(self, type_name: str, method: str,
                   batches: List[PendingBatch]) -> None:
        """Execute one (type, method) group: resolve, run the step, touch
        the use clock, route the emits.  Pull-mode stream deliveries run
        one by one first: their lanes are grouped by row against one
        layout stamp, which merging would break."""
        seg_batches = [b for b in batches if b.segments is not None]
        if seg_batches:
            for b in seg_batches:
                self._run_segments_batch(type_name, method, b)
            batches = [b for b in batches if b.segments is None]
            if not batches:
                return
        info = vector_type(type_name)
        arena = self.arena_for(type_name)
        stages = self._tick_stages
        t_res = time.perf_counter()
        # cross-shard exchange candidate (tensor/exchange.py): every batch
        # carries device keys (the address overflow lanes are delivered
        # again by) and no future (the exchange permutes lanes).  Final
        # eligibility also needs every resolution on the device; the
        # ledger records a candidate after that decision, so dropped lanes
        # count when they deliver.
        maybe_exchange = (
            self._exchange_live() and self.exchange.engaged()
            and arena.sharding is not None
            and all(b.future is None and b.keys_dev is not None
                    and b.keys_wide is None for b in batches))
        ledger = self.ledger
        if ledger.enabled and not maybe_exchange:
            # latency ledger, host-resolved side: injector and host-key
            # batches always fully deliver (host resolution activates),
            # so each is one numpy scalar add — recorded BEFORE
            # coalescing, which drops the per-batch stamps
            for b in batches:
                if b.inject_tick >= 0 and (b.keys_host is not None
                                           or b.rows is not None):
                    ledger.record_host(type_name, method,
                                       self.tick_number - b.inject_tick,
                                       len(b))
        batches = self._coalesce_host_batches(batches)
        # re-resolve if a batch's own resolution grew the arena
        while True:
            gen0 = arena.generation
            resolved = [self._resolve_batch(arena, b, method)
                        for b in batches]
            if arena.generation == gen0:
                break
        fan = self._fanouts.get((type_name, method))
        if fan is not None:
            self._expand_resolved_fanout(fan, batches, resolved)
        route = self._stream_routes.get((type_name, method))
        if route is not None and self._streams_live():
            self._expand_resolved_stream_routes(route, batches, resolved)
        # final exchange eligibility: every resolution stayed on the device
        # (a stale injector resolves on the host and this group runs
        # unexchanged this round) and every payload is lane-aligned
        will_exchange = maybe_exchange and not any(
            isinstance(r, np.ndarray) for r, _ in resolved) and all(
            exchangeable_args(b.args, len(b)) for b in batches)
        if ledger.enabled and not will_exchange:
            # device side: count exactly the lanes the step applies (mask
            # ∧ resolved, one K5 launch per batch); unresolved lanes count
            # when their redelivery applies, never twice
            for b, (rows, _a) in zip(batches, resolved):
                if b.inject_tick < 0:
                    continue
                if maybe_exchange:
                    # a candidate that fell back: its host-side record was
                    # skipped above — account it by its resolution kind
                    if isinstance(rows, np.ndarray):
                        ledger.record_host(type_name, method,
                                           self.tick_number - b.inject_tick,
                                           len(b))
                        continue
                elif b.keys_host is not None or b.rows is not None:
                    continue
                base = b.mask if b.mask is not None \
                    else self._mask_for(len(b))
                ledger.record_rows(type_name, method,
                                   self.tick_number - b.inject_tick,
                                   rows, base)
        if len(resolved) == 1:
            rows, args = resolved[0]
            mask = batches[0].mask
        else:
            rows, args, mask = self._concat_resolved(batches, resolved)

        host_rows = isinstance(rows, np.ndarray)
        if host_rows:
            # host batch: pad to a bucket; padding lanes carry row -1
            m_real = len(rows)
            bucket = self._bucket_for(m_real)
            if bucket != m_real:
                rows = np.concatenate(
                    [rows, np.full(bucket - m_real, -1, np.int32)])
                args = _map_tree(lambda a: _pad_leaf(a, bucket), args)
            mask_np = np.zeros(bucket, bool)
            mask_np[:m_real] = True
            rows = torch.from_numpy(rows).to(self.device)
            mask = torch.from_numpy(mask_np).to(self.device)
            m_total = m_real
        else:
            m_total = rows.shape[0]
        args = _map_tree(lambda a: _leaf_to_device(a, self.device), args)
        self.messages_processed += m_total
        t_x = time.perf_counter()
        stages["resolve"] += t_x - t_res
        if mask is None:
            mask = self._mask_for(rows.shape[0])
        if (not host_rows and self._exchange_live()
                and not self.exchange.engaged()
                and arena.sharding is not None
                and all(b.future is None and b.keys_dev is not None
                        and b.keys_wide is None for b in batches)
                and all(exchangeable_args(b.args, len(b))
                        for b in batches)):
            # DISENGAGED exchange (identity): the batch delivers as it is,
            # and every Nth eligible group of the site runs the
            # measure-only probe (K23) — the same eligibility as the
            # engaged path, so its counters estimate the traffic the
            # structured exchange would carry
            xch = self.exchange
            scale = xch.probe_scale(
                (type_name, method),
                max(1, self.config.exchange_probe_interval))
            if scale:
                self._exchange_checks.append(_ExchangeCheck(
                    type_name=type_name, method=method, keys=None,
                    args=None, dropped=None,
                    stats=xch._probe(arena, rows, mask, (type_name, method)),
                    measure_only=True, scale=scale))
        exchanged = False
        if will_exchange:
            rows, args, mask = self._exchange_group(
                arena, type_name, method, batches, rows, args, mask)
            exchanged = True
            stages["exchange"] += time.perf_counter() - t_x
        t_apply = time.perf_counter()
        if self.attribution.enabled:
            # fold the group's final rows (masked miss lanes count at
            # their redelivery; exchanged rows are the post-exchange ones,
            # so dropped lanes count at their redelivery too).  A single
            # unexchanged batch's emit keys are the delta-plan memo's
            # stable identity: its rows re-resolve to a fresh tensor every
            # tick (an exchange permutes lanes every tick).
            ident = batches[0].keys_dev \
                if len(batches) == 1 and not exchanged else None
            self.attribution.record_group(arena, type_name, method, rows,
                                          mask, ident=ident,
                                          host_rows=host_rows)

        step = self._get_step(info, method)
        new_state, results, emits, fence = step(arena.state, rows, args,
                                                mask)
        arena.adopt_state(new_state)
        self._tick_fence = fence
        if not host_rows:
            # device-routed batches never cross to the host: record their
            # traffic on the device-side use clock
            arena.touch_rows_dev(rows, self.tick_number)
        t_route = time.perf_counter()
        stages["apply"] += t_route - t_apply
        self._route_emits(emits)
        stages["route"] += time.perf_counter() - t_route
        if any(b.future is not None for b in batches):
            t_dr = time.perf_counter()
            self._deliver_results(batches, results)
            stages["results"] += time.perf_counter() - t_dr

    def _exchange_group(self, arena: GrainArena, type_name: str,
                        method: str, batches: List[PendingBatch],
                        rows: torch.Tensor, args: Any, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """The cross-shard exchange of one resolved device group (K23 or
        K24 through ``ShardExchange.dispatch``), or the round-start
        pre-dispatch of it while its stamps and rows still match.  The
        dropped mask and the stats park as an ``_ExchangeCheck`` with
        copies of the keys and the pre-exchange payload; the ledger
        records exactly the lanes delivered now.  Returns the exchanged
        (rows, args, mask)."""
        keys_cat = batches[0].keys_dev if len(batches) == 1 \
            else torch.cat([b.keys_dev for b in batches])
        orig_args = args
        pre = batches[0].pre_exchange if len(batches) == 1 else None
        xch = self.exchange
        if pre is not None and pre[5] == arena.generation \
                and pre[6] == arena.eviction_epoch and rows is pre[7]:
            # the round-start pre-dispatch already ran this batch's
            # exchange: its run counters fold now (it is the batch's one
            # exchange)
            rows, args, mask, dropped, stats = pre[:5]
            xch.fold_dispatch(pre[9])
            xch.note_overlap(time.perf_counter() - pre[8])
        else:
            if pre is not None:
                # stale: its deferred counters drop with it
                xch.pre_discards += 1
            rows, args, mask, dropped, stats = xch.dispatch(
                arena, rows, args, mask, site=(type_name, method))
        if len(batches) == 1:
            batches[0].pre_exchange = None
        # the ORIGINAL inject stamp rides the check (the earliest of the
        # group's stamped batches)
        inj = min((b.inject_tick for b in batches if b.inject_tick >= 0),
                  default=-1)
        self._exchange_checks.append(_ExchangeCheck(
            type_name=type_name, method=method, keys=_park_copy(keys_cat),
            args=_map_tree(_park_copy, orig_args), dropped=dropped,
            stats=stats, inject_tick=inj))
        if self.ledger.enabled and inj >= 0:
            # the lanes delivered this tick (dropped lanes count when they
            # are delivered again)
            self.ledger.record_rows(type_name, method,
                                    self.tick_number - inj, rows, mask)
        return rows, args, mask

    def _run_segments_batch(self, type_name: str, method: str,
                            b: PendingBatch) -> None:
        """One pull-mode stream delivery: the lanes are grouped by
        destination row with row-aligned offsets, so there is nothing to
        resolve and the step's reductions take K16.  The rows are exact
        while the arena's (generation, epoch) stamps hold; a stale batch
        (rows moved or freed since it was queued) is delivered again by
        key, whose device resolution re-activates evicted subscribers."""
        arena = self.arena_for(type_name)
        if b.generation != arena.generation \
                or b.epoch != arena.eviction_epoch:
            self.queues[(type_name, method)].append(PendingBatch(
                args=b.args, keys_dev=b.keys_dev, mask=b.mask,
                inject_tick=b.inject_tick))
            return
        info = vector_type(type_name)
        stages = self._tick_stages
        t0 = time.perf_counter()
        if self.ledger.enabled and b.inject_tick >= 0:
            self.ledger.record_rows(type_name, method,
                                    self.tick_number - b.inject_tick,
                                    b.rows, b.mask)
        if self.attribution.enabled:
            # the layout's key column is the delta-plan memo's identity:
            # one tensor per layout build
            self.attribution.record_group(arena, type_name, method, b.rows,
                                          b.mask, ident=b.keys_dev)
        self.messages_processed += len(b)
        t_apply = time.perf_counter()
        stages["resolve"] += t_apply - t0
        step = self._get_step(info, method)
        new_state, _results, emits, fence = step(arena.state, b.rows, b.args,
                                                 b.mask, b.segments)
        arena.adopt_state(new_state)
        self._tick_fence = fence
        # the offsets know which rows received: one dense pass (K17), not
        # a lane-sized scatter
        arena.touch_rows_dense(b.segments, self.tick_number)
        t_route = time.perf_counter()
        stages["apply"] += t_route - t_apply
        self._route_emits(emits)
        stages["route"] += time.perf_counter() - t_route

    @staticmethod
    def _deliver_results(batches: List[PendingBatch], results: Any) -> None:
        start = 0
        for b in batches:
            m = len(b)
            if b.future is not None and not b.future.done():
                if results is None:
                    b.future.set_result(None)
                else:
                    # device→host only here — the caller asked
                    b.future.set_result(_map_tree(
                        lambda x, s=start: x[s:s + m].cpu().numpy(),
                        results))
            start += m

    def _route_emits(self, emits) -> None:
        if not emits:
            return
        for emit in (emits if isinstance(emits, (tuple, list)) else (emits,)):
            if emit is None:
                continue
            keys = emit.keys
            if isinstance(keys, tuple):
                # a wide destination: an (hi, lo) int32 word pair
                self.queues[(emit.interface, emit.method)].append(
                    PendingBatch(args=emit.args,
                                 keys_wide=tuple(self._emit_keys(k)
                                                 for k in keys),
                                 mask=emit.mask,
                                 inject_tick=self.tick_number))
                continue
            keys = self._emit_keys(keys)
            self.queues[(emit.interface, emit.method)].append(PendingBatch(
                args=emit.args, keys_dev=keys, mask=emit.mask,
                inject_tick=self.tick_number))

    def _emit_keys(self, keys: Any) -> torch.Tensor:
        """Emit keys as an int32 device tensor."""
        if isinstance(keys, torch.Tensor):
            return keys.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(keys, dtype=np.int32),
                               device=self.device)

    # ================= steps ==============================================

    def _bucket_for(self, m: int) -> int:
        for b in self.config.bucket_sizes:
            if m <= b:
                return b
        # beyond the ladder: round up to a multiple of the last rung
        last = self.config.bucket_sizes[-1]
        return -(-m // last) * last

    def _get_step(self, info: VectorGrainInfo, method: str) -> Callable:
        key = (info.name, method)
        step = self._step_cache.get(key)
        if step is not None:
            return step
        handler = info.handlers[method]

        def step(state, rows, args, mask, segments=None):
            n_rows = next(iter(state.values())).shape[0]
            if not self.config.donate_state:
                # undonated: the handler's in-place scatters hit copies
                state = {k: v.clone() for k, v in state.items()}
            out = handler(state, Batch(rows=rows, args=args, mask=mask,
                                       segments=segments), n_rows)
            # normalize handler returns: state | (state,) |
            # (state, results) | (state, results, emits)
            if isinstance(out, dict):
                state2, results, emits = out, None, ()
            else:
                out = tuple(out)
                state2 = out[0]
                results = out[1] if len(out) > 1 else None
                emits = out[2] if len(out) > 2 else ()
            # the completion fence: an event after the handler's kernels
            # (reading a state column would wait on the next tick's
            # in-place updates too)
            fence = None
            if rows.is_cuda:
                fence = torch.cuda.Event()
                fence.record(torch.cuda.current_stream(rows.device))
            return state2, results, emits, fence

        self._step_cache[key] = step
        return step


class BatchInjector:
    """Cached-destination injection: the steady-state client edge.

    Resolves the key set once on the host (activating unseen keys), keeps
    the row vector on the device, and thereafter every ``inject`` queues
    the payload with those rows.  After a growth or compaction
    (generation) it re-resolves; after an eviction elsewhere in the arena
    (epoch only) one host lookup re-validates the cached rows, and it
    re-resolves only when one of its own keys lost its row."""

    def __init__(self, engine: TensorEngine, type_name: str, method: str,
                 keys: np.ndarray) -> None:
        self.engine = engine
        self.type_name = type_name
        self.method = method
        self.keys = keys
        self._arena = engine.arena_for(type_name)
        # device mirror of the key set: a registered fan-out expands the
        # injected batches with no host→device copy per inject
        self._keys_dev = host_upload(keys.astype(np.int32), engine.device) \
            if len(keys) and keys.max() < KEY_SENTINEL and keys.min() >= 0 \
            else None
        self.rows: Optional[torch.Tensor] = None
        self._rows_host: Optional[np.ndarray] = None  # epoch re-check
        self.generation = -2
        self.epoch = -2
        self.restore_epoch = -1
        self._refresh()

    def _refresh(self) -> None:
        arena = self._arena
        router = self.engine.router
        if router is not None and not router.handoff_settled():
            _, found = arena.lookup_rows(self.keys)
            if not found.all():
                # handoff fence: activating unseen keys here could read the
                # store before the previous owner's write-back.  No row
                # cache: inject() queues host-key batches, which the
                # engine fences (and resolves) at drain
                self.rows = None
                self.generation = -2  # never matches: retry next inject
                return
        if (self.rows is not None and self.generation == arena.generation
                and self.restore_epoch == arena.restore_epoch
                and self.epoch != arena.eviction_epoch):
            # epoch-only staleness: rows were freed somewhere, none moved.
            # If every key still resolves to ITS cached row, the device
            # rows are right: one host lookup and compare, no transfer.
            # Liveness alone is not enough — a key evicted and activated
            # again lands in another row.
            rows, found = arena.lookup_rows(self.keys)
            if found.all() and np.array_equal(rows, self._rows_host):
                self.epoch = arena.eviction_epoch
                return
        rows = arena.resolve_rows(self.keys, tick=self.engine.tick_number)
        # the host copy stays unspread (lookup_rows resolves to primaries,
        # so the epoch re-check above compares like with like); only the
        # device rows take the replica spread.  A promote or demote bumps
        # the generation, so spread rows never survive one through the
        # epoch-only path.
        self._rows_host = rows.astype(np.int32)
        rows = arena.spread_rows_host(rows)
        self.rows = torch.from_numpy(rows).to(self.engine.device)
        self.generation = arena.generation
        self.epoch = arena.eviction_epoch
        self.restore_epoch = arena.restore_epoch

    def inject(self, args: Any, want_results: bool = False
               ) -> Optional[asyncio.Future]:
        if self.generation != self._arena.generation \
                or self.epoch != self._arena.eviction_epoch \
                or self.restore_epoch != self._arena.restore_epoch:
            # rows moved (generation), freed (epoch) or a recovery point
            # replaced the row map (restore epoch)
            self._refresh()
        engine = self.engine
        future = asyncio.get_running_loop().create_future() \
            if want_results else None
        batch = PendingBatch(args=args, rows=self.rows, keys_host=self.keys,
                             keys_dev=self._keys_dev, future=future,
                             generation=self.generation, epoch=self.epoch,
                             inject_tick=engine.tick_number)
        if (self.type_name, self.method) in engine._journal_sites:
            # journaled ingress: the write-ahead append (copies the
            # device leaves) before the batch can run
            engine.checkpointer.journal_ingress(self.type_name, self.method,
                                                batch)
        engine.queues[(self.type_name, self.method)].append(batch)
        engine._wake_up()
        return future
