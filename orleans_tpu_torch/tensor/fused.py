"""Tick fusion: run a steady-state window of ticks as ONE device program.

The port of ``orleans_tpu/tensor/fused.py``.  At steady state the tick is
structurally constant: the same (type, method) arrives every tick, its
emits go to the same destination types, and the directory does not
change.  The JAX package traces one tick — source step → device-mirror
resolve → destination steps, recursively to the round cap — and scans it
over a window of T ticks in one XLA program.  The port runs the same
Python tick function:

* on the card, captured ONCE into a ``torch.cuda.CUDAGraph`` over all T
  ticks and replayed per window.  Per-tick leaves (the tick counter, a
  per-tick payload) ride in the graph's fixed ``[T, ...]`` input buffers,
  filled before each replay; tick ``t`` reads row ``t`` through a device
  pointer (K3's device-scalar mode for a 0-d leaf).  Static leaves, the
  source rows and the directory mirrors are baked in by address.  A
  capture or replay failure raises: nothing falls back to eager or
  unfused execution on the card;
* on the CPU, eagerly, tick by tick (the kernels' plain versions).

Steady-state contract (checked, not assumed):

* the injected key set is fixed for the window;
* every emit destination resolves in the directory mirror the window was
  built against — misses (and round-cap spills) add into a device total
  the window never reads; ``verify()`` reads it once, and a nonzero count
  means the window was not exact and the caller replays it unfused;
* the state columns the window updates stay where they were built
  (graphs bake addresses): an arena growth (generation), an eviction
  epoch, a directory-mirror rebuild, a ledger reconfiguration or a new
  window shape rebuilds the program first.

Inside a window every tick's messages complete in their own tick, so the
latency ledger records each applied lane at delta 0 (bucket 0), as the
JAX window does.  The workload-attribution plane folds each applied
group's rows into a per-window delta column and its slot counter (K7);
after the window's last tick one K7 adds each arena's delta into its
counts and its hashed buckets into its sketch, and the delta is zeroed —
the JAX window's scan carry plus its once-per-window sketch fold, equal
bit for bit because integer adds commute.

Wide ``(hi, lo)`` emit keys resolve through the destination's wide mirror
(K10), adding their misses into the window's total.  A registered fan-out
expands each applied source group inside the window (K11): the source
keys come from a device key-of-row column built with the window, the
expanded deliveries resolve like any emit, and the lanes that overflow
the expansion width add into the miss total (the chain then rolls back
and the unfused replay parks and redelivers them).  The window bakes the
fan-out's CSR tensors, so a rebuild of the follow graph rebuilds the
window (cause ``fanout_rebuild``); the JAX window keeps the graph it was
traced with (ROADMAP queue C).

A registered stream route (``tensor/streams_plane.py``) fans each applied
stream-ingress group out inside the window.  A source of the route's bound
key set takes the pull path: the payload is gathered per edge and the
subscriber group applies with the layout's ``segments``, so its reductions
and its in-window attribution fold take K16.  Any other source expands
push-mode through K11, its dropped lanes added into the miss total.  With
the plane switched off every routed source lane counts as a miss, so
``verify()`` fails and the unfused replay delivers through the host path.
The window warms every route's layouts before it captures and bakes their
tensors: a layout rebuild or a buffered mutation rebuilds the window
(cause ``stream_rebuild``), a toggle of the plane too (``config_toggle``).

An arena holding hot-grain replicas spreads every resolved emit inside the
window (K18, captured with the rest), and a static source's rows take the
arena's host spread when they resolve.  The graph bakes the replica
mirror's tensors: a promote or a demote rebuilds the window first (cause
``replica_change``), so a replay never reads a stale table.

A recovery point's adoption (``tensor/checkpoint.py``: ``adopt_layout``,
``adopt_columns``, ``adopt_delta``) replaces an arena's state tensors or
row map, yet restores the recorded generation and epoch, so those cannot
tell a window its baked addresses and rows are gone: each adoption bumps
the arena's ``restore_epoch`` and a window built before it rebuilds first
(cause ``restore``) — it never replays onto replaced storage.  Journal
fold-replay runs stacked windows through ``FusedTickProgram.replay``.

Over an arena of shard blocks with the exchange on and engaged
(``tensor/exchange.py``), every group is exchanged inside the window before
its step, as the JAX window threads the ``all_to_all`` through its scan:
K24 at the site's baked plan, or K23's classification where the plan is
cap 0.  A source with a static key set is packed home-block-local at the
build (``exchange_align_sources``): its leaves gather into the packed lane
order (statics once per window), and its own exchange is skipped.  The
dropped lanes add into the miss total, so ``verify()`` fails and the
auto-fuser replays the ticks unfused, and each site's demand max-merges
into a device accumulator that ``verify()`` reads with the totals and folds
into the estimators.  A grant move rebuilds the window (cause
``bucket_growth``), an exchange toggle too (``config_toggle``).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.hist import hist_count_many
from orleans_tpu_torch.kernels.scatter import _is_host_scalar
from orleans_tpu_torch.tensor.attribution import fold_cms_dense, fold_counts
from orleans_tpu_torch.tensor.engine import (
    _host_array,
    _gather_lanes,
    _leaf_to_device,
    _map_tree,
    resolve_rows_on_device,
)
from orleans_tpu_torch.tensor.exchange import exchangeable_args
from orleans_tpu_torch.tensor.vector_grain import Batch, ones_mask, vector_type

# why a program rebuilt (the causes of orleans_tpu/tensor/profiler.py's
# compile-churn taxonomy that this slice can meet, plus the port's own:
# a graph bakes the directory mirror's and the static leaves' addresses)
CAUSE_NEW_WINDOW = "new_window"
CAUSE_GENERATION_REPACK = "generation_repack"
CAUSE_EPOCH_MISMATCH = "epoch_mismatch"
CAUSE_CONFIG_TOGGLE = "config_toggle"
CAUSE_SHAPE_CHANGE = "shape_change"
CAUSE_MIRROR_REBUILD = "mirror_rebuild"
CAUSE_STATIC_CHANGE = "static_change"
CAUSE_FANOUT_REBUILD = "fanout_rebuild"
CAUSE_STREAM_REBUILD = "stream_rebuild"
CAUSE_REPLICA_CHANGE = "replica_change"
CAUSE_RESTORE = "restore"
CAUSE_BUCKET_GROWTH = "bucket_growth"


def plan_windows(window: int, n_ticks: int) -> Tuple[int, int, int]:
    """Uniform-window schedule of the fused load loops: one window shape
    for the whole run, ticks rounded UP to whole windows.  Returns
    (window, n_windows, total_ticks)."""
    window = max(1, min(window, n_ticks))
    n_windows = -(-n_ticks // window)
    return window, n_windows, n_windows * window


def _normalize(out):
    if isinstance(out, dict):
        return out, None, ()
    out = tuple(out)
    state = out[0]
    results = out[1] if len(out) > 1 else None
    emits = out[2] if len(out) > 2 else ()
    return state, results, emits


def _mirror_of(arena, wide: bool) -> Tuple[torch.Tensor, ...]:
    """The directory mirror a window resolves against (built if stale):
    the wide mirror for wide keys and for an arena holding wide keys,
    else the dense or the sorted one (``resolve_rows_on_device``).  The
    replica mirror changes only with a promote, a demote or a row move,
    which ``_replica_sig`` and the generation catch."""
    if wide or arena.has_wide_keys:
        return arena.device_index_wide()
    dense = arena.dense_index()
    return (dense,) if dense is not None else arena.device_index()


def _replica_sig(arena) -> Tuple[int, int]:
    """What a window depends on of an arena's replica groups: its promote
    and demote counts (each change also bumps the generation)."""
    return arena.replica_promotions, arena.replica_demotions


class _Source:
    """One injection pattern of a fused window.

    STATIC (the auto-fuser's mode): one key set, identical every tick —
    rows resolve once and are baked into the window.  STACKED
    (``_Source.stacked``, journal fold-replay): a per-tick ``[T, m]`` key
    matrix with a ``[T, m]`` presence mask; the caller passes each tick's
    rows and mask as the reserved per-tick leaves ``__rows__`` and
    ``__mask__`` (absent lanes: row -1, mask False — exact no-ops)."""

    def __init__(self, engine, type_name: str, method: str,
                 keys: np.ndarray) -> None:
        if vector_type(type_name) is None:
            raise KeyError(f"{type_name!r} is not a @vector_grain type")
        self.engine = engine
        self.type_name = type_name
        self.method = method
        self.arena = engine.arena_for(type_name)
        self.stacked_rows = False
        self.keys = np.asarray(keys, dtype=np.int64)
        self.refresh_rows()

    @classmethod
    def stacked(cls, engine, type_name: str, method: str,
                keys2d: np.ndarray, mask2d: np.ndarray) -> "_Source":
        if vector_type(type_name) is None:
            raise KeyError(f"{type_name!r} is not a @vector_grain type")
        self = cls.__new__(cls)
        self.engine = engine
        self.type_name = type_name
        self.method = method
        self.arena = engine.arena_for(type_name)
        self.stacked_rows = True
        self.keys2d = np.asarray(keys2d, dtype=np.int64)
        self.mask2d = np.asarray(mask2d, dtype=bool)
        self.lanes = int(self.keys2d.shape[1])
        # the flat unique key set (activation + re-resolution domain)
        self.keys = (np.unique(self.keys2d[self.mask2d])
                     if self.mask2d.any()
                     else np.empty(0, dtype=np.int64))
        self.refresh_rows()
        return self

    def refresh_rows(self) -> None:
        """(Re-)resolve keys → rows against the arena's current layout
        (activates missing keys — may grow the arena, so rollback
        snapshots come after; the ``prepare()`` contract)."""
        device = self.engine.device
        if not self.stacked_rows:
            rows = self.arena.spread_rows_host(
                self.arena.resolve_rows(self.keys))
            self.rows_host = rows.astype(np.int32)
            self.rows = torch.from_numpy(self.rows_host).to(device)
            self.mask = ones_mask(len(self.keys), device)
            return
        if len(self.keys):
            self.arena.resolve_rows(self.keys)
        flat = self.keys2d.reshape(-1).copy()
        flat[~self.mask2d.reshape(-1)] = -1
        rows, found = self.arena.lookup_rows(flat)
        rows = np.where(found, rows.astype(np.int64), np.int64(-1))
        self.rows2d = rows.reshape(self.keys2d.shape)


def _stage(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Per-tick leaves ``[T, ...]`` as tensors: numpy narrowed to 32 bits
    as JAX without x64 does, tensors as given."""
    if not isinstance(tree, dict):
        raise TypeError("per-tick args must be a dict of [T, ...] leaves")
    out = {}
    for k, v in tree.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
            if v.ndim == 0:
                raise ValueError(f"per-tick leaf {k!r} needs a leading "
                                 f"[T] axis")
            v = torch.from_numpy(np.ascontiguousarray(_host_array(v)))
        out[k] = v
    return out


def _copy_in(buf: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a window's input into a graph buffer without stalling the
    host: a host tensor goes through pinned memory, asynchronously (a
    copy from pageable memory would wait for the stream to drain)."""
    if src.device.type == "cpu" and buf.device.type == "cuda":
        src = src.pin_memory()
        buf.copy_(src, non_blocking=True)
    else:
        buf.copy_(src)


class FusedTickProgram:
    """One multi-tick program for one or more stable injection patterns.

    Built by ``TensorEngine.fuse_ticks`` (one pattern — ``run`` takes one
    per-tick/static dict pair), ``FusedTickProgram.multi`` (several
    concurrent patterns — ``run`` takes LISTS aligned with the sources,
    applied per tick in source order) or ``FusedTickProgram.replay``
    (stacked per-tick key sets).  ``run`` executes T ticks and updates
    the arenas' states; ``verify()`` returns the misses since the last
    verify (0 = every window was exact)."""

    def __init__(self, engine, type_name: str, method: str,
                 keys: np.ndarray) -> None:
        self.engine = engine
        self.sources = [_Source(engine, type_name, method, keys)]
        self._finish_init()

    @classmethod
    def multi(cls, engine, sources: List[Tuple[str, str, np.ndarray]]
              ) -> "FusedTickProgram":
        self = cls.__new__(cls)
        self.engine = engine
        self.sources = [_Source(engine, t, m, k) for t, m, k in sources]
        self._finish_init()
        return self

    @classmethod
    def replay(cls, engine,
               sites: List[Tuple[str, str, np.ndarray, np.ndarray]]
               ) -> "FusedTickProgram":
        """Stacked-rows window: each site is (type_name, method, keys2d
        [T, m], mask2d [T, m]), applied in site order each tick."""
        self = cls.__new__(cls)
        self.engine = engine
        self.sources = [_Source.stacked(engine, t, m, k2, mk)
                        for t, m, k2, mk in sites]
        self._finish_init()
        return self

    def _finish_init(self) -> None:
        self.n_msgs = sum(s.lanes if s.stacked_rows else len(s.keys)
                          for s in self.sources)
        self._built = False
        self._generations: Dict[str, int] = {}
        self._epochs: Dict[str, int] = {}
        self._restore_epochs: Dict[str, int] = {}
        # (promotions, demotions) of each touched arena at the build
        self._replica_sigs: Dict[str, Tuple[int, int]] = {}
        self._touched: List[str] = []
        # (arena, wide keys) pairs whose directory mirror the window
        # resolves against, and the mirror tensors it was built with
        # (identity-compared)
        self._resolved: List[Tuple[str, bool]] = []
        self._mirrors: Dict[Tuple[str, bool], Tuple[torch.Tensor, ...]] = {}
        # fan-outs: the registrations and CSR versions the window was
        # built with, and the device key-of-row column of each source type
        self._fanout_regs: Dict[Tuple[str, str], Tuple[Any, str, str]] = {}
        self._fanout_versions: Dict[int, Tuple[Any, int]] = {}
        self._key_cols: Dict[str, torch.Tensor] = {}
        # stream routes: the plane's toggle and the routes' signature the
        # window was built with
        self._streams_on = False
        self._stream_sig: Optional[Tuple] = None
        self._discovering = False
        self._counts: List[Tuple] = []
        # the cross-shard exchange: baked at build time like the ledger —
        # whether it runs, the sites it runs at with their (lanes in,
        # lanes out) and the plan signature; per source, the host packing
        # of an aligned source (or None); per site, the demand
        # accumulator (int32 [2n], max-merged each tick, read and zeroed
        # at verify)
        self._exchange_on = False
        self._exchange_shapes: List[Tuple] = []
        self._site_keys: Dict[str, Tuple[str, str]] = {}
        self._exchange_plan_sig: Optional[Tuple] = None
        self._align: List[Optional[Dict[str, Any]]] = \
            [None] * len(self.sources)
        self._xneed: Dict[str, torch.Tensor] = {}
        self._xneed_fresh = False
        # device [1, 2] int32: (misses, delivered) since the last verify,
        # added into in place by every window (one address for graphs)
        self._totals = torch.zeros((1, 2), dtype=torch.int32,
                                   device=self.engine.device)
        self._unread = False
        # latency ledger: baked at build time, like the JAX window
        self._ledger_on = False
        self._hist: Optional[torch.Tensor] = None
        # workload attribution: baked at build time too — the live
        # accumulators the window adds into (identity-compared) and the
        # program's per-window delta column per touched arena
        self._attr_sig: Optional[Tuple] = None
        self._attr: Dict[str, Any] = {}
        self._attr_delta: Dict[str, torch.Tensor] = {}
        self._built_donate: Optional[bool] = None
        # the card's form: the captured graph and everything it baked
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._in: List[Dict[str, torch.Tensor]] = []     # [T, ...] inputs
        self._static_keys: List[Dict[str, Any]] = []     # see _static_key
        self._static_bufs: List[Dict[str, torch.Tensor]] = []
        self._graph_statics: List[Dict[str, Any]] = []
        self._state_bufs: Dict[str, Dict[str, torch.Tensor]] = {}
        self._per_replay: Dict[str, int] = {}  # launches one replay makes
        self.rebuilds: Counter = Counter()      # cause → count
        self.build_seconds = 0.0                # the latest build's
        self.replays = 0

    @property
    def on_card(self) -> bool:
        return self.engine.device.type == "cuda"

    def _is_multi(self) -> bool:
        return len(self.sources) > 1

    def _as_lists(self, stacked_args: Any, static_args: Any
                  ) -> Tuple[List[Any], List[Any]]:
        if self._is_multi():
            return list(stacked_args), list(static_args or
                                            [{}] * len(self.sources))
        return [stacked_args], [static_args or {}]

    # -- the tick -------------------------------------------------------------

    def _apply_group(self, states: Dict[str, Dict[str, torch.Tensor]],
                     type_name: str, method: str, rows: torch.Tensor,
                     args: Any, mask: torch.Tensor, depth: int,
                     acc: Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[Dict[str, Any]]],
                     segments: Optional[torch.Tensor] = None,
                     host_keys: Optional[np.ndarray] = None,
                     aligned: bool = False
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Apply one (type, method) batch and recurse into its emits, its
        fan-out and its stream route — the unrolled multi-round tick.
        ``acc`` is (totals [1, 2], ledger hist or None, attribution
        {"delta": {type: column}, "slots"} or None), all added into in
        place: K1/K2 add each resolve's misses into totals[0, 0], K5 the
        delivered lanes into totals[0, 1], round-cap spills into
        totals[0, 0] and the applied lanes into hist[slot, 0] (K5's counts
        wait in ``self._counts`` for the tick's end); K7 (K16 for
        a pull-mode delivery) folds the applied rows into the type's delta
        column and the lanes into the attribution slot.  ``segments``
        marks a pull-mode delivery; ``host_keys`` is a static source's key
        set, which a stream route matches against its bound key set;
        ``aligned`` marks a source packed home-block-local at the build,
        whose exchange is skipped.

        With the exchange on and engaged, every group over an arena of
        shard blocks is exchanged first (K23 or K24 in the window): its
        dropped lanes add into totals[0, 0] (the window is then not exact,
        and the unfused replay delivers them again) and its demand
        max-merges into the site's accumulator ``acc[3]``."""
        engine = self.engine
        info = vector_type(type_name)
        handler = info.handlers[method]
        if type_name not in states:
            states[type_name] = self._discover_state(type_name)
        n_rows = next(iter(states[type_name].values())).shape[0]
        totals, hist, attr, xneed = acc
        xch = engine.exchange
        if self._exchange_on and xch is not None and not aligned \
                and xch.engaged() and segments is None:
            arena = engine.arena_for(type_name)
            if arena.sharding is not None:
                site = (type_name, method)
                rows, args, mask, dropped, need = xch.apply_traced(
                    site, int(arena.shard_capacity), rows, args, mask)
                totals[0, 0].add_(dropped)
                skey = f"{type_name}.{method}"
                acc_x = xneed.get(skey)
                if acc_x is None:
                    if not self._discovering:
                        raise RuntimeError(f"fused window: no exchange "
                                           f"demand for {skey!r}")
                    xneed[skey] = need.clone()
                else:
                    torch.maximum(acc_x, need, out=acc_x)
        state2, _results, emits = _normalize(handler(
            states[type_name], Batch(rows=rows, args=args, mask=mask,
                                     segments=segments), n_rows))
        states[type_name] = state2
        if hist is not None:
            # every applied lane completes in its own (virtual) tick:
            # delta 0, bucket 0
            self._count(hist, engine.ledger.slot_for(type_name, method), 0,
                        mask)
        if attr is not None:
            delta = attr["delta"].get(type_name)
            if delta is None:
                if not self._discovering:
                    raise RuntimeError(f"fused window: no attribution delta "
                                       f"for {type_name!r}")
                delta = attr["delta"][type_name] = torch.zeros(
                    n_rows, dtype=torch.int32, device=engine.device)
            fold_counts(delta, attr["slots"],
                        engine.attribution.slots.slot_for(type_name, method),
                        rows, mask, segments=segments)
        at_cap = depth >= engine.config.max_rounds_per_tick

        out_batches = []
        for e in (emits if isinstance(emits, (tuple, list)) else (emits,)):
            if e is None:
                continue
            # wide destination keys: an (hi, lo) int32 word pair
            ekeys = tuple(engine._emit_keys(k) for k in e.keys) \
                if isinstance(e.keys, tuple) else engine._emit_keys(e.keys)
            m = (ekeys[0] if isinstance(ekeys, tuple) else ekeys).shape[0]
            emask = e.mask if e.mask is not None \
                else ones_mask(m, engine.device)
            eargs = _map_tree(lambda a: _leaf_to_device(a, engine.device),
                              e.args)
            out_batches.append((e.interface, e.method, ekeys, eargs, emask))

        fan = engine._fanouts.get((type_name, method))
        if fan is not None and not at_cap:
            # the registered fan-out, inside the window: lanes past the
            # expansion width add into the miss total
            fanout, dst_type, dst_method = fan
            self._fanout_versions[id(fanout)] = (
                fanout, fanout.current_version())
            dkeys, dargs, dvalid = fanout.expand(
                self._src_keys_for(type_name, rows), args, mask,
                n_dropped=totals[0, 0])
            fanout.take_drop()
            out_batches.append((dst_type, dst_method, dkeys, dargs, dvalid))
        elif fan is not None:
            # a fan-out the round cap keeps from running would lose its
            # deliveries: count its source lanes as misses
            self._count(totals, 0, 0, mask)

        route = engine._stream_routes.get((type_name, method)) \
            if self._streams_on else None
        if route is not None and not at_cap:
            dst_arena = engine.arena_for(route.type_name)
            self._note_arena(route.type_name, dst_arena)
            pull = route.pull_layout(dst_arena) \
                if route._matches_bound(host_keys) else None
            if pull is not None and pull["n_edges"] > 0:
                # the pull path: the payload gathered per edge, the
                # subscriber group applied with the layout's offsets
                lane = pull["src_lane"]
                gargs = _map_tree(lambda a: _gather_lanes(a, lane), args)
                if isinstance(gargs, dict) and "src_key" not in gargs:
                    gargs = {**gargs, "src_key": pull["src_key"]}
                emask = mask.index_select(0, lane)
                self._count(totals, 0, 1, emask)
                states = self._apply_group(
                    states, route.type_name, route.method, pull["rows"],
                    gargs, emask, depth + 1, acc, segments=pull["offsets"])
            else:
                # the push path: expand to subscriber keys, resolve like
                # an emit; lanes past the width add into the miss total
                dkeys, dargs, dvalid = route.expand(
                    self._src_keys_for(type_name, rows), args, mask,
                    n_dropped=totals[0, 0])
                route.take_drop()
                out_batches.append((route.type_name, route.method, dkeys,
                                    dargs, dvalid))
        elif route is not None or (
                not self._streams_on
                and (type_name, method) in engine._stream_routes):
            # a route the round cap keeps from running, or one whose
            # deliveries belong to the host path (the plane is off): its
            # source lanes count as misses, so verify() fails and the
            # unfused replay delivers them
            self._count(totals, 0, 0, mask)

        if at_cap:
            # the unfused engine SPILLS round-cap emits to the next tick;
            # a window cannot, so they count as misses: verify() then
            # says the chain is too deep to fuse
            for _t, _m, _k, _a, emask in out_batches:
                self._count(totals, 0, 0, emask)
            return states

        for dst_type, dst_method, ekeys, eargs, emask in out_batches:
            dst_arena = engine.arena_for(dst_type)
            self._note_arena(dst_type, dst_arena)
            site = (dst_type, isinstance(ekeys, tuple))
            if site not in self._resolved:
                self._resolved.append(site)
            drows, _ = resolve_rows_on_device(dst_arena, ekeys, emask,
                                              misses=totals[0, 0])
            self._count(totals, 0, 1, emask)
            states = self._apply_group(states, dst_type, dst_method, drows,
                                       eargs, drows >= 0, depth + 1, acc)
        return states

    def _count(self, hist: torch.Tensor, slot: int, bucket: int,
               mask: torch.Tensor) -> None:
        """A K5 count of ``mask`` into ``hist[slot, bucket]``, held until
        the tick's end (the list keeps its mask alive and unchanged: no
        step of a tick writes a mask in place)."""
        self._counts.append((hist, slot, bucket, mask, None))

    def _apply_all(self, states, statics: List[Dict[str, Any]],
                   per_tick: List[Dict[str, torch.Tensor]], acc):
        """One tick: every source's group, then the tick's K5 counts in
        one launch (``hist_count_many``; integer sums, so their order
        leaves ``hist`` and the totals exact)."""
        self._counts = []
        for i, src in enumerate(self.sources):
            al = self._align[i]
            args_i = {**statics[i], **(per_tick[i] if al is None else
                                       self._align_tree(i, per_tick[i]))}
            if src.stacked_rows:
                rows_i = args_i.pop("__rows__")
                mask_i = args_i.pop("__mask__")
            elif al is not None:
                rows_i, mask_i = al["rows"], al["mask"]
            else:
                rows_i, mask_i = src.rows, src.mask
            states = self._apply_group(
                states, src.type_name, src.method, rows_i, args_i, mask_i, 1,
                acc, host_keys=None if src.stacked_rows else src.keys,
                aligned=al is not None)
        counts, self._counts = self._counts, []
        hist_count_many(counts)
        return states

    def _align_tree(self, i: int, tree: Dict[str, Any]) -> Dict[str, Any]:
        """One source's lane-aligned leaves gathered into its packed
        home-block-local lane order (scalars and 0-d leaves pass
        through)."""
        take = self._align[i]["take"]
        return _map_tree(lambda a: _gather_lanes(a, take), tree)

    def _aligned_statics(self, statics: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
        """Aligned sources' static leaves in their packed lane order,
        gathered once per window, outside the ticks."""
        return [st if self._align[i] is None else self._align_tree(i, st)
                for i, st in enumerate(statics)]

    def _run_ticks(self, states, statics, stackeds, n_ticks: int, acc):
        statics = self._aligned_statics(statics)
        for t in range(n_ticks):
            per_tick = [{k: v[t] for k, v in st.items()} for st in stackeds]
            states = self._apply_all(states, statics, per_tick, acc)
        if acc[2] is not None:
            # once per window: each arena's delta into its counts and its
            # sketch (K7 weighted), then a zeroed delta for the next window
            seeds = self.engine.attribution.seeds
            for n in self._touched:
                delta = acc[2]["delta"][n]
                fold_cms_dense(self._attr["cms"][n], delta, seeds,
                               counts=self._attr["counts"][n])
                delta.zero_()
        return states

    def _acc(self) -> Tuple:
        """A run's accumulators: (totals, ledger hist, attribution, exchange
        demand)."""
        return self._totals, self._hist, self._attr_acc(), self._xneed

    def _fold_xneed(self, host: Optional[List[np.ndarray]] = None) -> None:
        """Fold the demand the windows accumulated per site since the last
        fold into the exchange's estimators (``host``: the accumulators
        already read) and zero the accumulators."""
        if not self._xneed or not self._xneed_fresh:
            return
        self._xneed_fresh = False
        xch = self.engine.exchange
        if host is None:
            host = list(torch.stack(list(self._xneed.values()))
                        .cpu().numpy())
        for (skey, acc), vec in zip(self._xneed.items(), host):
            site = self._site_keys.get(skey)
            if xch is not None and site is not None:
                xch.observe_need(site, np.asarray(vec))
            acc.zero_()

    def _attr_acc(self) -> Optional[Dict[str, Any]]:
        """The attribution part of a run's accumulators."""
        if not self._attr:
            return None
        return {"delta": self._attr_delta, "slots": self._attr["slots"]}

    def _src_keys_for(self, type_name: str,
                      rows: torch.Tensor) -> torch.Tensor:
        """The grain keys of ``rows`` for a fan-out's source lanes: a
        gather from a device key-of-row column built with the window
        (keys clipped into the int32 fan-out key range, free rows 0, as
        the JAX window's constant); a rebuild of the window (growth, a
        mirror change) builds it anew."""
        col = self._key_cols.get(type_name)
        if col is None:
            if not self._discovering:
                raise RuntimeError(f"fused window: no key column for "
                                   f"{type_name!r}")
            key_of_row = self.engine.arena_for(type_name)._key_of_row
            col = self._key_cols[type_name] = _leaf_to_device(
                key_of_row.clip(0, 2**31 - 2).astype(np.int32),
                self.engine.device)
        return col.index_select(0, rows.clamp(0, col.shape[0] - 1))

    def _note_arena(self, name: str, arena) -> None:
        if name not in self._generations:
            self._generations[name] = arena.generation
            self._epochs[name] = arena.eviction_epoch
            self._restore_epochs[name] = arena.restore_epoch
            self._replica_sigs[name] = _replica_sig(arena)
            self._touched.append(name)

    def _discover_state(self, type_name: str) -> Dict[str, torch.Tensor]:
        """Discovery pass only: a destination arena met for the first time
        joins the window (created if need be) with a scratch copy of its
        columns; after discovery every touched arena is known."""
        if not self._discovering:
            raise RuntimeError(
                f"fused window reached {type_name!r}, which its discovery "
                f"pass did not: the emit graph changed without a rebuild")
        arena = self.engine.arena_for(type_name)
        self._note_arena(type_name, arena)
        return {k: v.clone() for k, v in arena.state.items()}

    # -- build ----------------------------------------------------------------

    def _baked(self, v: Any) -> bool:
        """A static leaf a graph bakes as it is: a tensor already on the
        card (by address) or a host scalar (by value).  Any other leaf is
        copied into a fixed device buffer before every replay."""
        if _is_host_scalar(v):
            return True
        return isinstance(v, torch.Tensor) \
            and v.device.type == self.engine.device.type

    def _static_key(self, v: Any) -> Any:
        """What a graph depends on of a static leaf: a baked tensor's
        identity (the graph keeps it alive, so the id stays unique), a
        host scalar's type and value, a copied leaf's shape and dtype."""
        if isinstance(v, torch.Tensor):
            return ("tensor", id(v)) if self._baked(v) \
                else ("copied", tuple(v.shape), v.dtype)
        if _is_host_scalar(v):
            return ("scalar", type(v), v.item() if hasattr(v, "item") else v)
        a = _host_array(np.asarray(v))
        return ("copied", a.shape, a.dtype)

    def _statics_for_run(self, statics: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
        """Static leaves as the window reads them: tensors on the device,
        host scalars as they are, other leaves moved to the device — on
        the card into the graph's fixed buffers."""
        dev = self.engine.device
        out = []
        for i, st in enumerate(statics):
            d = {}
            for k, v in st.items():
                if self._graph is not None and k in self._static_bufs[i]:
                    buf = self._static_bufs[i][k]
                    _copy_in(buf, v if isinstance(v, torch.Tensor) else
                             torch.from_numpy(np.ascontiguousarray(
                                 _host_array(np.asarray(v)))))
                    d[k] = buf
                elif isinstance(v, torch.Tensor):
                    d[k] = v.to(dev)
                else:
                    d[k] = _leaf_to_device(v, dev)
            out.append(d)
        return out

    def _rebuild_cause(self, stackeds: List[Dict[str, torch.Tensor]],
                       statics: List[Dict[str, Any]]) -> Optional[str]:
        engine = self.engine
        if not self._built:
            return CAUSE_NEW_WINDOW
        if any(engine.arena_for(n).restore_epoch != r
               for n, r in self._restore_epochs.items()):
            return CAUSE_RESTORE
        if any(_replica_sig(engine.arena_for(n)) != sig
               for n, sig in self._replica_sigs.items()):
            return CAUSE_REPLICA_CHANGE
        if any(engine.arena_for(n).generation != g
               for n, g in self._generations.items()):
            return CAUSE_GENERATION_REPACK
        if any(engine.arena_for(n).eviction_epoch != e
               for n, e in self._epochs.items()):
            return CAUSE_EPOCH_MISMATCH
        ledger = engine.ledger
        if self._ledger_on != ledger.enabled or (
                self._ledger_on and self._hist is not ledger.device_hist_in()
        ) or self._built_donate != engine.config.donate_state \
                or self._attr_sig != engine.attribution.build_signature() \
                or not self._attr_live():
            return CAUSE_CONFIG_TOGGLE
        for (n, wide), mirror in self._mirrors.items():
            now = _mirror_of(engine.arena_for(n), wide)
            if len(now) != len(mirror) or any(
                    a is not b for a, b in zip(now, mirror)):
                return CAUSE_MIRROR_REBUILD
        if engine._fanouts != self._fanout_regs or any(
                fan.current_version() != v
                for fan, v in self._fanout_versions.values()):
            return CAUSE_FANOUT_REBUILD
        if self._streams_on != engine._streams_live() \
                or self._exchange_on != engine._exchange_live():
            return CAUSE_CONFIG_TOGGLE
        if self._stream_sig != engine._stream_routes_signature():
            return CAUSE_STREAM_REBUILD
        if self._exchange_on and engine.exchange is not None \
                and self._exchange_plan_sig != engine.exchange \
                .plan_signature(list(self._site_keys.values())):
            # a grant moved (the estimators fold at drains and verifies
            # only, so a steady stream never rebuilds per tick) or the
            # sizing knobs changed: the window baked the old layouts
            return CAUSE_BUCKET_GROWTH
        if self._graph is None:
            return None
        for buf, st in zip(self._in, stackeds):
            if set(buf) != set(st) or any(
                    buf[k].shape != v.shape or buf[k].dtype != v.dtype
                    for k, v in st.items()):
                return CAUSE_SHAPE_CHANGE
        for keys, st in zip(self._static_keys, statics):
            if keys != {k: self._static_key(v) for k, v in st.items()}:
                return CAUSE_STATIC_CHANGE
        return None

    def _attr_live(self) -> bool:
        """Whether the accumulators the window adds into are still the
        plane's live tensors (flushing the plane's buffered folds)."""
        live = self.engine.attribution.device_state_in(self._touched)
        if not live or not self._attr:
            return not live and not self._attr
        return live["slots"] is self._attr["slots"] and all(
            live[kind][n] is self._attr[kind][n]
            for kind in ("counts", "cms") for n in self._touched)

    def prepare(self, stacked_args: Any, static_args: Any = None) -> None:
        """Re-resolve the source rows and rebuild when anything the window
        was built against moved.  Idempotent; ``run`` calls it first.
        Callers that snapshot arena state for rollback (the auto-fuser)
        call it BEFORE the snapshot: re-resolution can activate keys and
        grow an arena."""
        stackeds, statics = self._as_lists(stacked_args, static_args)
        self._prepare([_stage(s) for s in stackeds], statics)

    def _prepare(self, stackeds: List[Dict[str, torch.Tensor]],
                 statics: List[Dict[str, Any]]) -> int:
        """``prepare`` on staged per-tick leaves; returns the window's
        tick count."""
        leaves = [v for st in stackeds for v in st.values()]
        if not leaves:
            raise ValueError(
                "stacked_args needs at least one [T, ...] leaf (e.g. a "
                "tick counter) — it sets the window length")
        n_ticks = leaves[0].shape[0]
        cause = self._rebuild_cause(stackeds, statics)
        if cause is not None:
            self.rebuilds[cause] += 1
            # pending demand folds under the old site layout first
            self._fold_xneed()
            for s in self.sources:
                s.refresh_rows()
            t0 = time.perf_counter()
            self._build(stackeds, statics, n_ticks)
            self.build_seconds = time.perf_counter() - t0
        return n_ticks

    def _build(self, stackeds: List[Dict[str, torch.Tensor]],
               statics: List[Dict[str, Any]], n_ticks: int) -> None:
        engine = self.engine
        dev = engine.device
        self._graph = None
        self._ledger_on = engine.ledger.enabled
        self._hist = engine.ledger.device_hist_in() if self._ledger_on \
            else None
        self._built_donate = engine.config.donate_state
        att = engine.attribution
        self._attr_sig = att.build_signature()
        self._attr, self._attr_delta = {}, {}
        # discovery: one tick on scratch copies of every arena it touches
        # (and of the accumulators) — finds the destination arenas,
        # builds their directory mirrors, and on the card launches every
        # kernel once before capture
        self._generations, self._epochs, self._replica_sigs = {}, {}, {}
        self._restore_epochs = {}
        self._touched, self._resolved = [], []
        self._fanout_regs = dict(engine._fanouts)
        self._fanout_versions, self._key_cols = {}, {}
        # stream routes: warm every layout now — the window bakes their
        # tensors, and a rebuild during the capture would raise
        self._streams_on = engine._streams_live()
        if self._streams_on:
            for route in engine._stream_routes.values():
                route.pull_layout(engine.arena_for(route.type_name))
                route.push_csr(dev)
        for s in self.sources:
            self._note_arena(s.type_name, s.arena)
        self._build_exchange(stackeds, statics)
        xch = engine.exchange
        if xch is not None:
            xch.trace_log = []
        states = {s.type_name: {k: v.clone() for k, v in
                                s.arena.state.items()}
                  for s in self.sources}
        hist = self._hist.clone() if self._hist is not None else None
        scratch_attr = {"delta": {}, "slots": att.device_state_in(
            [])["slots"].clone()} if att.enabled else None
        scratch_xneed: Dict[str, torch.Tensor] = {}
        first = [{k: v[0].to(dev) for k, v in st.items()} for st in stackeds]
        self._discovering = True
        try:
            self._apply_all(states, self._aligned_statics(
                self._statics_for_run(statics)), first,
                            (self._totals.clone(), hist, scratch_attr,
                             scratch_xneed))
        finally:
            self._discovering = False
        del states, scratch_attr
        # the exchange sites the discovery tick met, their widths, the
        # plans they baked, and a zeroed demand accumulator per site
        shapes = list(xch.trace_log) \
            if self._exchange_on and xch is not None else []
        self._exchange_shapes = shapes
        self._site_keys = {}
        for site, _mi, _mo in shapes:
            self._site_keys.setdefault(f"{site[0]}.{site[1]}", site)
        self._exchange_plan_sig = xch.plan_signature(
            list(self._site_keys.values())) \
            if self._exchange_on and xch is not None else None
        self._xneed = {k: torch.zeros_like(v)
                       for k, v in scratch_xneed.items()}
        self._xneed_fresh = False
        if att.enabled:
            # every touched arena's live accumulators (flushed) and a
            # zeroed delta column the window's ticks fold into
            self._attr = att.device_state_in(self._touched)
            self._attr_delta = {
                n: torch.zeros_like(self._attr["counts"][n])
                for n in self._touched}
        self._mirrors = {(n, wide): _mirror_of(engine.arena_for(n), wide)
                         for n, wide in self._resolved}
        self._stream_sig = engine._stream_routes_signature()
        self._built = True
        if self.on_card:
            self._capture(stackeds, statics, n_ticks)

    def _build_exchange(self, stackeds: List[Dict[str, torch.Tensor]],
                        statics: List[Dict[str, Any]]) -> None:
        """Bake the exchange: whether it runs and, with
        ``exchange_align_sources``, the host packing of every source with
        a static key set (``ShardExchange.align_plan``) — its lanes
        gathered home-block-local, so its exchange is skipped; its emits
        inherit the packed width, a transport width the next exchange
        keeps split exactly.  Sources of a stream route keep their lane
        order (pull layouts address the bound key order)."""
        engine = self.engine
        dev = engine.device
        self._exchange_on = engine._exchange_live()
        self._align = [None] * len(self.sources)
        if not (self._exchange_on and engine.exchange.engaged()
                and engine.config.exchange_align_sources):
            return
        for i, s in enumerate(self.sources):
            example = {**statics[i],
                       **{k: v[0] for k, v in stackeds[i].items()}}
            if s.stacked_rows or s.arena.sharding is None \
                    or (s.type_name, s.method) in engine._stream_routes \
                    or not exchangeable_args(example, len(s.keys)):
                continue
            plan = engine.exchange.align_plan(s.rows_host,
                                              int(s.arena.shard_capacity))
            if plan is None:
                continue
            engine.exchange.note_transport_width(len(plan["rows"]))
            self._align[i] = {
                "take": _leaf_to_device(
                    np.clip(plan["take"], 0, None).astype(np.int32), dev),
                "rows": _leaf_to_device(plan["rows"], dev),
                "mask": _leaf_to_device(plan["take"] >= 0, dev)}

    def _capture(self, stackeds: List[Dict[str, torch.Tensor]],
                 statics: List[Dict[str, Any]], n_ticks: int) -> None:
        """Capture the T ticks into one CUDA graph.  Its state buffers are
        the arenas' live columns (private copies when state is not
        donated); the window ends by copying any column a handler
        replaced back into its buffer, so every replay reads and writes
        the same addresses."""
        engine = self.engine
        dev = engine.device
        self._in = [{k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                     for k, v in st.items()} for st in stackeds]
        self._static_bufs = [
            {k: (v.to(dev) if isinstance(v, torch.Tensor)
                 else _leaf_to_device(v, dev)).clone()
             for k, v in st.items() if not self._baked(v)}
            for st in statics]
        self._static_keys = [{k: self._static_key(v) for k, v in st.items()}
                             for st in statics]
        # the leaves the graph reads; holding them keeps every baked
        # address (and id) alive as long as the graph
        self._graph_statics = [
            {k: self._static_bufs[i].get(k, v) for k, v in st.items()}
            for i, st in enumerate(statics)]
        donate = engine.config.donate_state
        self._state_bufs = {
            n: (dict(engine.arena_for(n).state) if donate else
                {k: v.clone() for k, v in engine.arena_for(n).state.items()})
            for n in self._touched}
        graph = torch.cuda.CUDAGraph()
        before = _build.captured_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            states = {n: dict(bufs) for n, bufs in self._state_bufs.items()}
            states = self._run_ticks(states, self._graph_statics, self._in,
                                     n_ticks, self._acc())
            for n, bufs in self._state_bufs.items():
                self._copy_back(n, bufs, states[n])
        after = _build.captured_counts()
        self._per_replay = {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}
        self._graph = graph

    def _copy_back(self, name: str, bufs: Dict[str, torch.Tensor],
                   cols: Dict[str, torch.Tensor]) -> None:
        for c, buf in bufs.items():
            col = cols.get(c)
            if col is None or col.shape != buf.shape \
                    or col.dtype != buf.dtype:
                raise ValueError(f"fused window: {name}.{c} lost its "
                                 f"column or changed shape or dtype")
            if col is not buf:
                buf.copy_(col)

    # -- run ------------------------------------------------------------------

    def run(self, stacked_args: Any, static_args: Any = None) -> None:
        """Execute T fused ticks.

        ``stacked_args``: dict of genuinely per-tick leaves with a leading
        [T, ...] axis (e.g. the tick counter).  ``static_args``: leaves
        identical every tick, at their natural [m, ...] shape.  Multi-
        source programs take LISTS of both, aligned with ``sources``."""
        engine = self.engine
        stackeds, statics = self._as_lists(stacked_args, static_args)
        staged = [_stage(s) for s in stackeds]
        n_ticks = self._prepare(staged, statics)
        donate = engine.config.donate_state
        if self.on_card:
            for bufs, st in zip(self._in, staged):
                for k, v in st.items():
                    _copy_in(bufs[k], v)
            self._statics_for_run(statics)  # host arrays into their buffers
            for n, bufs in self._state_bufs.items():
                live = engine.arena_for(n).state
                for c, buf in bufs.items():
                    if live[c] is not buf:  # unfused ticks replaced it
                        buf.copy_(live[c])
            self._graph.replay()
            self.replays += 1
            _build.note_replay(self._per_replay)
            fence = torch.cuda.Event()
            fence.record(torch.cuda.current_stream(engine.device))
            engine._tick_fence = fence
            for n, bufs in self._state_bufs.items():
                engine.arena_for(n).adopt_state(
                    dict(bufs) if donate
                    else {k: v.clone() for k, v in bufs.items()})
        else:
            states = {n: (dict(engine.arena_for(n).state) if donate else
                          {k: v.clone() for k, v in
                           engine.arena_for(n).state.items()})
                      for n in self._touched}
            states = self._run_ticks(
                states, self._statics_for_run(statics),
                [{k: v.to(engine.device) for k, v in st.items()}
                 for st in staged],
                n_ticks, self._acc())
            for n in self._touched:
                engine.arena_for(n).adopt_state(states[n])
        if self._ledger_on:
            engine.ledger.device_hist_out(self._hist)
        engine.attribution.device_state_out(self._attr)
        self._unread = True
        if self._exchange_on and engine.exchange is not None:
            engine.exchange.fold_fused_shapes(self._exchange_shapes, n_ticks)
            self._xneed_fresh = True
        engine.tick_number += n_ticks
        engine.messages_processed += n_ticks * self.n_msgs
        # the window advanced the tick clock without the engine's touch
        # path: every live row of a fused arena counts as used now
        for n in self._touched:
            engine.arena_for(n).fused_use_tick = engine.tick_number

    def verify(self) -> int:
        """Sync point: misses (cold destinations, round-cap spills) across
        ``run`` calls since the last verify — nonzero means the windows
        were NOT exact and their ticks must re-run unfused; an exchange's
        dropped lanes count among them.  Folds the windows' delivered emit
        count into the engine's messages_processed and their exchange
        demand into the estimators (a dropped lane both fails the window
        and grows the grant, so the rebuilt window fits).  ONE device read
        however many windows ran."""
        if not self._unread:
            self._fold_xneed()
            return 0
        fresh = self._xneed_fresh and bool(self._xneed)
        parts = [self._totals.view(-1)] + (list(self._xneed.values())
                                           if fresh else [])
        host = torch.cat(parts).cpu().numpy()
        misses, delivered = int(host[0]), int(host[1])
        if fresh:
            n2 = 2 * self.engine.n_shards
            self._fold_xneed([host[2 + k * n2:2 + (k + 1) * n2]
                              for k in range(len(self._xneed))])
        self._totals.zero_()
        self._unread = False
        self.engine.messages_processed += delivered
        return misses
