"""WorkloadAttribution: device-resident hot-grain and skew accounting.

The port of ``orleans_tpu/tensor/attribution.py``.  Three structures per
engine live on the device and are updated in place, so each keeps one
address while its shape stands (a fused window's CUDA graph adds into
them directly):

* **per-row traffic counts**: one int32 column per arena, folded with
  each executing batch's destination rows (masked and out-of-range lanes
  add nothing);
* **a count-min sketch**: int32 ``[depth, width]`` per arena, the same
  rows hashed ``depth`` ways (``cms_hash``); its per-key estimate never
  undercounts;
* **per-(type, method) slot counts**: int32 ``[MAX_SLOTS]`` sharing the
  latency ledger's ``SlotRegistry``.

Unfused ticks do not fold at once.  ``record_group`` resolves a **dense
delta plan** per (type, method) — the bincount of the batch's valid
lanes, the sketch's hashed delta and the lane total, built by K7 into
zeroed buffers — and buffers the fold; ``flush_folds`` applies the
buffer before any read, at the buffer cap and before a fused window:

* runs of **host-proven** folds of one plan as one K8 ``k·delta``
  multiply-add.  Host-proven means the batch's anchor (the stable emit
  keys, else the rows) and mask are the very tensors the plan was built
  from, their in-place version counters have not moved since (unlike a
  JAX array, a tensor can be rewritten in place), and for key-anchored
  plans the arena's (generation, eviction epoch, live count) stands;
* **device-checked** folds (same shapes, unproven content) as one K8
  match of every entry against the plan, the ``k_match·delta``
  multiply-add with the match count read on the device, and one K7 full
  fold per entry gated on its mismatch flag, which bumps the stale
  counter that the next snapshot reads to drop the plans.

Inside a fused window each tick folds counts and slots with K7 into a
per-window delta column; once per window K7 adds the delta into the
counts and its hashed buckets into the sketch, and the delta is zeroed
(integer adds commute, so this is bit-identical to per-lane folds).  A
flush never runs while a CUDA graph is being captured: it would be
recorded and replayed with every window.  The auto-fuser pins the plane
by copy at a chain's start and restores it in place on rollback.

Snapshots run K9 per arena and read every arena's outputs, the slot
counts and the stale counter with one device-to-host copy.  An eviction
retires the victims' counts to a host mirror by key (``on_evict``: a K13
gather, one copy, then K3 zeroes the rows in place).  A pull-mode
delivery of the streams plane folds its row-aligned lanes through K16's
count mode (``fold_counts`` with ``segments``).  Mesh resharding belongs
to a later slice of the port (``fold_type`` and ``relocate`` raise).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from orleans_tpu_torch.device import host_upload
from orleans_tpu_torch.kernels.attr import (
    MAX_STACK,
    attr_apply,
    attr_fold,
    attr_match,
    attr_snapshot,
    decode_snapshot,
    snapshot_size,
)
from orleans_tpu_torch.kernels.lifecycle import gather_rows
from orleans_tpu_torch.kernels.pull import seg_pull
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.ledger import MAX_SLOTS, SlotRegistry

#: multiply-shift seed per sketch depth (the JAX package's constants)
CMS_SEEDS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
             0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
MAX_CMS_DEPTH = len(CMS_SEEDS)

#: bound on the (type, method) → delta-plan memo (cleared wholesale)
_MAX_PLANS = 128

#: buffered folds flushed per coalesced dispatch
_FLUSH_CAP = 32

_RESHARD = ("belongs to the multi-shard slice of the port (migration "
            "and resharding)")


def pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


# -- the programs of orleans_tpu/tensor/attribution.py, in place -------------

def fold_counts(counts, slots, slot: int, rows, valid,
                segments=None) -> None:
    """The fused window's per-tick fold: counts and the slot counter, no
    sketch (K7).  A pull-mode delivery (``segments``, its row-aligned
    offsets) folds through K16's count mode instead: each row adds the
    count of its valid lanes, and the slot every valid lane."""
    if segments is not None:
        seg_pull(valid, segments, "sum", out=counts, slots=slots, slot=slot)
        return
    attr_fold(counts, None, (), rows, valid, total=slots, slot=slot)


def fold_cms_dense(cms, counts_delta, seeds, counts=None) -> None:
    """The sketch fold of a dense per-row delta (K7 weighted mode); with
    ``counts`` given the delta also adds into the counts."""
    attr_fold(counts, cms, seeds, weight=counts_delta)


def _plan_kernel(rows, valid, seeds, cap: int, width: int, depth: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch's dense delta plan: (counts delta [cap], sketch delta
    [depth, width], lane total [1]), by K7 into zeroed buffers."""
    dev = rows.device
    cdelta = torch.zeros(cap, dtype=torch.int32, device=dev)
    sdelta = torch.zeros((depth, width), dtype=torch.int32, device=dev)
    n = torch.zeros(1, dtype=torch.int32, device=dev)
    attr_fold(cdelta, sdelta, seeds, rows, valid, total=n, slot=0)
    return cdelta, sdelta, n


def _apply_checked_stack(counts, cms, slots, stale, plan_rows, plan_valid,
                         counts_delta, cms_delta, n, seeds, slot: int,
                         rows_list: Sequence[torch.Tensor],
                         valid_list: Sequence[torch.Tensor]) -> None:
    """Device-checked folds against one plan: the matching entries as
    one ``k_match·delta`` multiply-add, each mismatched entry as its full
    fold (bumping ``stale``).  The host never learns which matched."""
    dev = counts.device
    for lo in range(0, len(rows_list), MAX_STACK):
        rs = rows_list[lo:lo + MAX_STACK]
        vs = valid_list[lo:lo + MAX_STACK]
        flags = torch.empty(len(rs), dtype=torch.int32, device=dev)
        km = torch.empty(1, dtype=torch.int32, device=dev)
        attr_match(rs, vs, plan_rows, plan_valid, flags, km)
        attr_apply(counts, counts_delta, cms, cms_delta, km, total=slots,
                   slot=slot, n=n)
        for e, (r, v) in enumerate(zip(rs, vs)):
            attr_fold(counts, cms, seeds, r, v, total=slots, slot=slot,
                      gate=flags[e:e + 1], stale=stale)


def _capturing() -> bool:
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


class WorkloadAttribution:
    """Per-engine workload attribution plane (see module docstring)."""

    def __init__(self, engine, enabled: bool = True, top_k: int = 16,
                 cms_depth: int = 4, cms_width: int = 8192,
                 slots: Optional[SlotRegistry] = None) -> None:
        self.engine = engine
        self.enabled = enabled
        self.top_k = max(1, int(top_k))
        self.cms_depth = max(1, min(int(cms_depth), MAX_CMS_DEPTH))
        self.cms_width = pow2ceil(max(16, int(cms_width)))
        self.slots = slots if slots is not None else SlotRegistry()
        self._counts: Dict[str, torch.Tensor] = {}   # type → int32[capacity]
        self._cms: Dict[str, torch.Tensor] = {}      # type → [depth, width]
        self._slot_counts: Optional[torch.Tensor] = None  # int32[MAX_SLOTS]
        # host mirror of counts retired off the device column, per type:
        # grain key → messages (eviction retires here; convert carries
        # it), merged per key at snapshot
        self._retired: Dict[str, Dict[int, int]] = {}
        self.records = 0
        self.d2h_fetches = 0
        self.retired_rows = 0
        self._retire_version = 0
        self._snap_cache: Optional[Tuple[Tuple[int, int], Dict]] = None
        # (type, method) → (anchor, anchor version, mask, mask version,
        # epoch, plan); plan = (rows, valid, counts delta, sketch delta,
        # lane total), rows and valid copied at build time
        self._plans: Dict[Tuple[str, str], Tuple] = {}
        self._stale: Optional[torch.Tensor] = None  # device mismatch count
        self._last_stale = 0
        # buffered (type, slot, plan, rows, mask, checked) folds
        self._pending: List[Tuple] = []
        # rollback pin buffers, reused while their shapes stand
        self._pin_bufs: Dict[Tuple[str, str], torch.Tensor] = {}
        self.plan_hits = 0
        self.plan_checked = 0
        self.plan_builds = 0

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def seeds(self) -> Tuple[int, ...]:
        return CMS_SEEDS[:self.cms_depth]

    # -- configuration -------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  top_k: Optional[int] = None,
                  cms_depth: Optional[int] = None,
                  cms_width: Optional[int] = None) -> None:
        """Live reload.  Changing the sketch layout resets the sketches;
        the counts and the retired mirror survive."""
        self.flush_folds()  # buffered folds assume the old layout
        if enabled is not None:
            self.enabled = enabled
        if top_k is not None:
            self.top_k = max(1, int(top_k))
        reshape = False
        if cms_depth is not None:
            d = max(1, min(int(cms_depth), MAX_CMS_DEPTH))
            reshape |= d != self.cms_depth
            self.cms_depth = d
        if cms_width is not None:
            w = pow2ceil(max(16, int(cms_width)))
            reshape |= w != self.cms_width
            self.cms_width = w
        if reshape:
            self._cms = {}
            self._plans = {}  # plans bake the sketch layout
        self._snap_cache = None

    def build_signature(self) -> Tuple:
        """What a fused window bakes in: a change rebuilds it."""
        return (self.enabled, self.cms_depth, self.cms_width)

    def reset(self) -> None:
        """Zero everything."""
        self._pending = []
        self._counts = {}
        self._cms = {}
        self._slot_counts = None
        self._retired = {}
        self._retire_version += 1
        self._snap_cache = None

    # -- accumulator access --------------------------------------------------

    def counts_for(self, type_name: str) -> torch.Tensor:
        col = self._counts.get(type_name)
        arena = self.engine.arenas.get(type_name)
        cap = arena.capacity if arena is not None \
            else self.engine.initial_capacity
        if col is not None and col.shape[0] != cap:
            # the capacity moved without the remap hook (direct arena
            # surgery): the JAX plane folds the column to the host mirror
            self.fold_type(type_name)
        if col is None:
            col = torch.zeros(cap, dtype=torch.int32, device=self.device)
            self._counts[type_name] = col
        return col

    def cms_for(self, type_name: str) -> torch.Tensor:
        sk = self._cms.get(type_name)
        if sk is None:
            sk = torch.zeros((self.cms_depth, self.cms_width),
                             dtype=torch.int32, device=self.device)
            self._cms[type_name] = sk
        return sk

    def _slot_arr(self) -> torch.Tensor:
        if self._slot_counts is None:
            self._slot_counts = torch.zeros(MAX_SLOTS, dtype=torch.int32,
                                            device=self.device)
        return self._slot_counts

    def _stale_arr(self) -> torch.Tensor:
        if self._stale is None:
            self._stale = torch.zeros(1, dtype=torch.int32,
                                      device=self.device)
        return self._stale

    # -- hot path ------------------------------------------------------------

    def record_group(self, arena, type_name: str, method: str,
                     rows: torch.Tensor, mask: torch.Tensor, ident=None,
                     host_rows: bool = False) -> None:
        """One executing (type, method) group's fold, buffered with its
        delta plan (see the module docstring).  ``host_rows``: the rows
        came from host resolution this call, so no identity can prove or
        check a plan — the JAX package's numpy batches, which build a plan
        every time and are never memoized."""
        if not self.enabled:
            return
        slot = self.slots.slot_for(type_name, method)
        counts = self.counts_for(type_name)
        cms = self.cms_for(type_name)
        anchor = rows if ident is None else ident
        given_mask = mask
        epoch = (arena.generation, arena.eviction_epoch,
                 arena.live_count) if arena is not None else None
        key = (type_name, method)
        entry = None if host_rows else self._plans.get(key)
        plan = None
        checked = False
        if entry is not None:
            e_anchor, e_av, e_mask, e_mv, e_epoch, e_plan = entry
            shapes_ok = (e_plan[2].shape[0] == counts.shape[0]
                         and e_plan[3].shape == cms.shape
                         and rows.shape == e_plan[0].shape)
            if shapes_ok and e_anchor is anchor and e_mask is mask \
                    and anchor._version == e_av and mask._version == e_mv \
                    and (ident is None or e_epoch == epoch):
                plan = e_plan
                self.plan_hits += 1
                rows, mask = plan[0], plan[1]
            elif shapes_ok:
                plan = e_plan
                checked = True
                self.plan_checked += 1
                # the compare runs at the flush: hold this call's content
                rows, mask = rows.clone(), mask.clone()
        if plan is None:
            delta = _plan_kernel(rows, mask, self.seeds, cap=counts.shape[0],
                                 width=cms.shape[1], depth=cms.shape[0])
            plan = (rows.clone(), mask.clone()) + delta
            rows, mask = plan[0], plan[1]
            self.plan_builds += 1
            if not host_rows:
                if len(self._plans) >= _MAX_PLANS:
                    self._plans.clear()
                self._plans[key] = (anchor, anchor._version, given_mask,
                                    given_mask._version, epoch, plan)
        self._pending.append((type_name, slot, plan, rows, mask, checked))
        self.records += 1
        self._snap_cache = None
        if len(self._pending) >= _FLUSH_CAP:
            self.flush_folds()

    def flush_folds(self) -> None:
        """Apply every buffered fold: runs of one plan as one K8
        multiply-add (host-proven) or one K8 match + multiply-add + gated
        K7 folds (device-checked).  Called on the buffer cap and before any
        read or row-lifecycle change of the accumulators.  Deferred while
        a CUDA graph is being captured: a flush recorded into the graph
        would replay with every window."""
        if not self._pending or _capturing():
            return
        pending, self._pending = self._pending, []
        groups: Dict[Tuple, List] = {}
        for e in pending:
            groups.setdefault((e[0], e[1], id(e[2]), e[5]), []).append(e)
        for (type_name, slot, _pid, checked), entries in groups.items():
            counts = self.counts_for(type_name)
            cms = self.cms_for(type_name)
            plan_rows, plan_valid, cdelta, sdelta, n = entries[0][2]
            if cdelta.shape[0] != counts.shape[0] \
                    or sdelta.shape != cms.shape:
                raise RuntimeError(
                    "attribution: the accumulator layout changed under "
                    "buffered folds without a flush")
            if checked:
                _apply_checked_stack(
                    counts, cms, self._slot_arr(), self._stale_arr(),
                    plan_rows, plan_valid, cdelta, sdelta, n, self.seeds,
                    slot, [e[3] for e in entries], [e[4] for e in entries])
            else:  # k host-proven folds of one plan: one multiply-add
                attr_apply(counts, cdelta, cms, sdelta, len(entries),
                           total=self._slot_arr(), slot=slot, n=n)

    # -- fused-window integration --------------------------------------------

    def device_state_in(self, touched: List[str]) -> Dict[str, Any]:
        """The accumulators a fused window adds into (flushed, and created
        for every touched arena); empty when the plane is disabled."""
        if not self.enabled:
            return {}
        self.flush_folds()  # the window must see every recorded fold
        return {"counts": {t: self.counts_for(t) for t in touched},
                "cms": {t: self.cms_for(t) for t in touched},
                "slots": self._slot_arr()}

    def device_state_out(self, attr: Dict[str, Any]) -> None:
        """A fused window added into ``attr`` (the live tensors)."""
        if not attr:
            return
        if attr["slots"] is not self._slot_counts or any(
                self._counts.get(t) is not c
                for t, c in attr["counts"].items()):
            raise ValueError("fused window accumulated into stale "
                             "attribution tensors")
        self.records += 1
        self._snap_cache = None

    def _pin(self, kind: str, name: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._pin_bufs.get((kind, name))
        if buf is None or buf.shape != t.shape or buf.device != t.device:
            buf = self._pin_bufs[(kind, name)] = torch.empty_like(t)
        buf.copy_(t)
        return buf

    def snapshot_state(self) -> Tuple:
        """Rollback pin for the auto-fuser's verification chain: a copy of
        every accumulator into pin buffers (windows add into the live
        tensors in place) and of the retired mirror.  No accumulator is
        created, dropped or reshaped mid-chain: every row move and pattern
        break settles the chain first."""
        self.flush_folds()
        counts = {t: self._pin("counts", t, c)
                  for t, c in self._counts.items()}
        cms = {t: self._pin("cms", t, s) for t, s in self._cms.items()}
        slots = self._pin("slots", "", self._slot_counts) \
            if self._slot_counts is not None else None
        return (counts, cms, slots,
                {t: dict(d) for t, d in self._retired.items()},
                self.retired_rows)

    def restore_state(self, state: Tuple) -> None:
        """Undo every fold since ``snapshot_state``: copy the pins back
        INTO the live tensors, so a window's graph keeps its addresses.
        An accumulator created after the pin goes, as in the JAX plane."""
        counts, cms, slots, retired, retired_rows = state
        for live, pinned in ((self._counts, counts), (self._cms, cms)):
            for t in [t for t in live if t not in pinned]:
                del live[t]
            for t, pin in pinned.items():
                live[t].copy_(pin)
        if slots is None:
            self._slot_counts = None
        else:
            self._slot_arr().copy_(slots)
        self._retired = {t: dict(d) for t, d in retired.items()}
        self.retired_rows = retired_rows
        self._retire_version += 1
        self._snap_cache = None

    # -- row lifecycle hooks (the arena calls these) -------------------------

    def has_state(self, type_name: str) -> bool:
        return type_name in self._counts

    def on_evict(self, arena, victims: np.ndarray, keys: np.ndarray) -> None:
        """Retire evicted rows' counts to the host mirror by key before
        their rows return to the free list (a reused row must never
        inherit the evicted grain's traffic): the buffered folds flush, a
        K13 gather reads the victims' counts with one copy, and one K3 SET
        zeroes their rows in place, so the column keeps its address."""
        self.flush_folds()  # retire post-fold counts
        col = self._counts.get(arena.info.name)
        if col is None or len(victims) == 0:
            return
        idx = host_upload(np.asarray(victims, dtype=np.int32), self.device)
        vals = gather_rows(col, idx).cpu().numpy()
        retired = self._retired.setdefault(arena.info.name, {})
        nz = vals > 0
        for k, v in zip(np.asarray(keys)[nz].tolist(), vals[nz].tolist()):
            retired[k] = retired.get(k, 0) + int(v)
        row_scatter(col, idx, 0, "set")
        self.retired_rows += len(victims)
        self._retire_version += 1
        self._snap_cache = None

    def fold_type(self, type_name: str, arena=None) -> None:
        raise NotImplementedError(
            f"attribution fold_type {_RESHARD}: the counts column of "
            f"{type_name!r} no longer matches its arena's capacity")

    def relocate(self) -> None:
        raise NotImplementedError(f"attribution relocate {_RESHARD}")

    def remap_rows(self, arena, old_rows: np.ndarray, new_rows: np.ndarray,
                   new_capacity: int) -> None:
        """Row move (growth): the counts move with their rows on the
        device, so keys keep their totals.  Buffered folds target the old
        layout and flush first."""
        self.flush_folds()
        col = self._counts.get(arena.info.name)
        if col is None:
            return
        new = torch.zeros(new_capacity, dtype=torch.int32,
                          device=self.device)
        dst = torch.as_tensor(np.asarray(new_rows, np.int64),
                              device=self.device)
        src = torch.as_tensor(np.asarray(old_rows, np.int64),
                              device=self.device)
        new[dst] = col[src]
        self._counts[arena.info.name] = new
        self._snap_cache = None

    # -- snapshots -----------------------------------------------------------

    def _confidence(self) -> float:
        return 1.0 - math.exp(-float(self.cms_depth))

    def snapshot(self, cache: bool = True) -> Dict[str, Any]:
        """The attribution snapshot: per-arena HotSet + skew gauges +
        per-method traffic.  K9 per arena; every arena's outputs, the slot
        counts and the stale counter cross to the host in ONE copy
        (``d2h_fetches`` counts it).  ``cache=True`` reuses the last
        snapshot while no fold or retirement happened since."""
        self.flush_folds()
        key = (self.records, self._retire_version)
        if cache and self._snap_cache is not None \
                and self._snap_cache[0] == key:
            return self._snap_cache[1]
        parts: List[torch.Tensor] = []
        metas: List[Tuple[str, Any, int]] = []
        for type_name, col in self._counts.items():
            arena = self.engine.arenas.get(type_name)
            if arena is None or arena.capacity != col.shape[0]:
                continue
            k = min(self.top_k, col.shape[0])
            parts.append(attr_snapshot(col, self.cms_for(type_name),
                                       self.seeds, k, arena.n_shards))
            metas.append((type_name, arena, k))
        has_slots = self._slot_counts is not None
        has_stale = self._stale is not None
        if has_slots:
            parts.append(self._slot_counts.to(torch.int64))
        if has_stale:
            parts.append(self._stale.to(torch.int64))
        fetched = torch.cat(parts).cpu().numpy() if parts \
            else np.zeros(0, np.int64)
        if parts:
            self.d2h_fetches += 1
        at = 0
        outs = []
        for _t, arena, k in metas:
            size = snapshot_size(k, arena.n_shards)
            outs.append(decode_snapshot(fetched[at:at + size], k,
                                        arena.n_shards))
            at += size
        slots = None
        if has_slots:
            slots = fetched[at:at + MAX_SLOTS]
            at += MAX_SLOTS
        stale_now = int(fetched[at]) if has_stale else self._last_stale
        if stale_now > self._last_stale:
            # checked folds mismatched since the last snapshot: the plans'
            # content drifted from the live batches — rebuild them
            self._plans.clear()
        self._last_stale = stale_now
        arenas: Dict[str, Any] = {}
        for (type_name, arena, _k), o in zip(metas, outs):
            arenas[type_name] = self._arena_snapshot(type_name, arena, o)
        methods: Dict[str, int] = {}
        if slots is not None:
            for (t, m), s in self.slots.items():
                if int(slots[s]):
                    methods[f"{t}.{m}"] = int(slots[s])
        out = {
            "arenas": arenas,
            "methods": methods,
            "top_k": self.top_k,
            "sketch": {
                "depth": self.cms_depth,
                "width": self.cms_width,
                "epsilon": math.e / self.cms_width,
                "confidence": round(self._confidence(), 6),
            },
        }
        self._snap_cache = (key, out)
        return out

    def _arena_snapshot(self, type_name: str, arena,
                        o: Dict[str, Any]) -> Dict[str, Any]:
        """The host half of one arena's snapshot: top rows back to grain
        keys, merged with the retired mirror, and the skew gauges."""
        total = o["total"]
        retired = self._retired.get(type_name, {})
        cand: Dict[int, Dict[str, int]] = {}
        for v, r, e in zip(o["vals"].tolist(), o["rows"].tolist(),
                           o["est"].tolist()):
            if v <= 0:
                continue
            k = int(arena._key_of_row[r])
            if k < 0:
                continue  # freed between fold and snapshot
            cand[k] = {"msgs": int(v), "sketch": int(e)}
        for k, v in cand.items():
            if k in retired:
                v["msgs"] += retired[k]
                v["sketch"] += retired[k]
        if retired:
            floor = min((v["msgs"] for v in cand.values()), default=0) \
                if len(cand) >= self.top_k else 0
            extra = [(k, c) for k, c in retired.items()
                     if k not in cand and c > floor]
            extra.sort(key=lambda kv: -kv[1])
            extra = extra[:self.top_k]
            if extra:
                # the live remainder of retired keys that may join: a
                # small gather (plain torch: only an engine carried
                # across with a retired mirror reaches it)
                ekeys = np.asarray([k for k, _ in extra], np.int64)
                erows, found = arena.lookup_rows(ekeys)
                live = np.zeros(len(extra), np.int64)
                if found.any():
                    idx = torch.as_tensor(erows[found].astype(np.int64),
                                          device=self.device)
                    live[found] = self._counts[type_name][idx].cpu().numpy()
                    self.d2h_fetches += 1
                for (k, c), lc in zip(extra, live.tolist()):
                    cand[k] = {"msgs": int(c) + int(lc),
                               "sketch": int(c) + int(lc)}
        retired_total = sum(retired.values())
        grand = total + retired_total
        hot = sorted(cand.items(), key=lambda kv: -kv[1]["msgs"])
        hot = hot[:self.top_k]
        conf = self._confidence()
        # sketch_est clamps below at the exact count: a row move strands
        # a key's sketch history in buckets hashed from its old row
        hot_set = [{
            "key": k,
            "msgs": v["msgs"],
            "share": round(v["msgs"] / grand, 6) if grand else 0.0,
            "sketch_est": max(v["sketch"], v["msgs"]),
            "confidence": round(conf, 6),
        } for k, v in hot]
        shard_l = [int(x) for x in o["shard"]]
        mean_nz = float(o["mean_nz"])
        return {
            "hot": hot_set,
            "total_msgs": grand,
            "live_msgs": total,
            "retired_msgs": retired_total,
            "topk_share": round(sum(h["msgs"] for h in hot_set) / grand, 6)
            if grand else 0.0,
            "skew": {
                "max_shard_share": round(max(shard_l) / total, 6)
                if total else 0.0,
                "gini": round(float(o["gini"]), 6),
                "p99_to_mean": round(float(o["p99"]) / mean_nz, 4)
                if mean_nz else 0.0,
                "hot_rows": o["nnz"],
            },
            "shard_msgs": shard_l,
        }

    def hot_set(self) -> List[Dict[str, Any]]:
        """One entry per hot grain across all arenas, by message count."""
        if not self.enabled:
            return []
        snap = self.snapshot(cache=True)
        out = []
        for type_name, a in snap["arenas"].items():
            for h in a["hot"]:
                out.append({"arena": type_name, **h})
        out.sort(key=lambda h: -h["msgs"])
        return out[:self.top_k]

    def per_key_totals(self, type_name: str) -> Dict[int, int]:
        """EXACT per-grain totals, live + retired merged per key (one
        full-column device-to-host copy; diagnostics only)."""
        self.flush_folds()
        out = {k: int(v)
               for k, v in self._retired.get(type_name, {}).items()}
        col = self._counts.get(type_name)
        arena = self.engine.arenas.get(type_name)
        if col is None or arena is None or arena.capacity != col.shape[0]:
            return out
        vals = col.cpu().numpy()
        self.d2h_fetches += 1
        rows = np.nonzero(vals)[0]
        keys = arena._key_of_row[rows]
        live = keys >= 0
        for k, v in zip(keys[live].tolist(), vals[rows[live]].tolist()):
            out[k] = out.get(k, 0) + int(v)
        return out

    def stats(self) -> Dict[str, Any]:
        """Cheap host-side plane health (no transfer)."""
        return {
            "enabled": self.enabled,
            "top_k": self.top_k,
            "cms_depth": self.cms_depth,
            "cms_width": self.cms_width,
            "tracked_arenas": len(self._counts),
            "records": self.records,
            "d2h_fetches": self.d2h_fetches,
            "retired_rows": self.retired_rows,
            "retired_keys": sum(len(d) for d in self._retired.values()),
            "plan_hits": self.plan_hits,
            "plan_checked": self.plan_checked,
            "plan_builds": self.plan_builds,
            "pending_folds": len(self._pending),
            "stale_folds": self._last_stale,
        }
