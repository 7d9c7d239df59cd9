"""ShardExchange: cross-shard message routing between the shard blocks of
one card.

The port of ``orleans_tpu/tensor/exchange.py``.  Under a ``ShardMesh`` of
n blocks (tensor/mesh.py) an arena's rows split into n blocks, and a batch
whose lanes lie in one block's chunk but address rows of another is
exchanged before its step runs, as the JAX engine does over a device mesh:

1. **bucket** — each source chunk (lanes ``[s * L, (s + 1) * L)`` of the
   padded batch) classifies its lanes by destination block (``rows //
   shard_capacity``, the directory's ``shard_of_keys`` by construction)
   and ranks each cross lane among its chunk's lanes bound for the same
   block, stably, in lane order;
2. **exchange** — where the JAX body moves the buckets with one
   ``lax.all_to_all`` (or ``all_gather`` in the per-destination layout),
   K24 (``kernels/exchange.py``) writes each lane straight into its
   receiving block's region of the output: on one card every block shares
   one memory, so the collective is the write itself;
3. **fold** — the received lanes carry rows of their receiver's block, and
   the step applies them as it applies any batch.

**Occupancy-sized buckets**: each exchange measures the per-destination
demand (``need``, overflow included) on the device and a per-(type,
method) estimator quantizes its peak onto the ladder {2^k} ∪ {3·2^(k-1)}:
caps grow at once when demand overflows and shrink after
``exchange_shrink_patience`` calm drains.  A site measured at zero demand
plans ``cap == 0``, a classification pass only (K23 cap-0 mode), which is
also what a source packed home-block-local on the host (``align_plan``)
gets.  Before any measurement the plan falls back to the worst-case
formula (``exchange_pad_quantum`` × ``exchange_capacity_factor``).

Exactness: a lane that does not fit its bucket is never lost.  The
dropped mask parks like a miss check, and the engine delivers the dropped
lanes again next tick with their original inject stamp; inside a fused
window the dropped count joins the window's miss counter, so ``verify()``
fails and the auto-fuser rolls back and replays unfused.

Engagement (``exchange_structured``): "always" runs the structured
exchange, "never" never does, and "auto" engages it only when the mesh's
blocks span more than one device.  The JAX rule is ``platform != "cpu"``:
on a host-virtual mesh every collective is a copy inside one process and
the structured region costs more than the scatter it replaces.  A
``ShardMesh`` on one card is such a virtual mesh, so "auto" disengages
there: batches deliver as they are (identity) and every
``exchange_probe_interval``-th eligible group runs the measure-only probe
(K23 probe mode), which keeps the cross-traffic counters and the demand
estimates honest.

Ordering caveat (as in the JAX package): the exchange permutes lane order
within a (type, method) batch.  Delivery sets are preserved exactly;
handlers that resolve duplicate-row writes by lane order should combine
with ``seg_*`` instead.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels.exchange import (
    exchange_buckets,
    exchange_classify,
)
from orleans_tpu_torch.kernels.router import (
    is_scalar_leaf,
    tree_leaves,
    tree_replace,
)

#: estimator site key: the (type_name, method) a batch executes as
Site = Tuple[str, str]


def pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def ladder_ceil(n: int) -> int:
    """Smallest ladder rung ≥ n, rungs {2^k} ∪ {3·2^(k-1)} (1, 2, 3, 4, 6,
    8, 12, ...): at most 33% overshoot, O(log) distinct values.  0 maps
    to 0."""
    n = int(n)
    if n <= 0:
        return 0
    p = pow2ceil(n)
    three = 3 * (p // 4)
    return three if three >= n else p


class _SiteEstimator:
    """Measured bucket demand for one (type, method) exchange site: the
    per-destination peak and a quantized grant that grows at once and
    shrinks only after ``patience`` calm observations (the JAX
    estimator, unchanged)."""

    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards
        self.peak = np.zeros(n_shards, np.int64)
        self._window = np.zeros(n_shards, np.int64)
        self._obs = 0
        self.grant: Optional[int] = None
        self.observations = 0
        # per-destination formulation: one rung per destination and one
        # receive rung over the worst block's total inbound
        self.grants: Optional[np.ndarray] = None
        self.recv_grant: Optional[int] = None
        self.peak_inbound = np.zeros(n_shards, np.int64)
        self.last_need = np.zeros(n_shards, np.int64)
        self._window_pd = np.zeros(n_shards, np.int64)
        self._window_in = np.zeros(n_shards, np.int64)
        self._obs_pd = 0

    @staticmethod
    def _rungs(vec: np.ndarray, headroom: float) -> np.ndarray:
        return np.array([ladder_ceil(int(np.ceil(float(v) * headroom)))
                         if v > 0 else 0 for v in vec], np.int64)

    def observe(self, need: np.ndarray, headroom: float, patience: int,
                inbound: Optional[np.ndarray] = None) -> Tuple[bool, bool]:
        """Fold one drained need vector (per-destination demand maxed over
        sources; ``inbound`` the same summed over sources, or ``need``
        again); returns (legacy grant changed, per-dest grants
        changed)."""
        need = np.asarray(need, np.int64)
        inb = need if inbound is None else np.asarray(inbound, np.int64)
        self.peak = np.maximum(self.peak, need)
        self.peak_inbound = np.maximum(self.peak_inbound, inb)
        self.last_need = need
        self._window = np.maximum(self._window, need)
        self._obs += 1
        self.observations += 1
        changed = False
        want = ladder_ceil(int(np.ceil(float(need.max()) * headroom))) \
            if need.max() > 0 else 0
        if self.grant is None or want > self.grant:
            self.grant = want
            self._window = np.zeros(self.n_shards, np.int64)
            self._obs = 0
            changed = True
        elif self._obs >= max(1, int(patience)):
            calm = ladder_ceil(int(np.ceil(float(self._window.max())
                                           * headroom)))
            self._window = np.zeros(self.n_shards, np.int64)
            self._obs = 0
            if calm < self.grant:
                self.grant = calm
                changed = True
        self._window_pd = np.maximum(self._window_pd, need)
        self._window_in = np.maximum(self._window_in, inb)
        self._obs_pd += 1
        changed_pd = False
        want_pd = self._rungs(need, headroom)
        want_r = ladder_ceil(int(np.ceil(float(inb.max()) * headroom))) \
            if inb.max() > 0 else 0
        if self.grants is None or (want_pd > self.grants).any() \
                or want_r > self.recv_grant:
            self.grants = want_pd if self.grants is None \
                else np.maximum(self.grants, want_pd)
            self.recv_grant = want_r if self.recv_grant is None \
                else max(self.recv_grant, want_r)
            self._window_pd = np.zeros(self.n_shards, np.int64)
            self._window_in = np.zeros(self.n_shards, np.int64)
            self._obs_pd = 0
            changed_pd = True
        elif self._obs_pd >= max(1, int(patience)):
            calm_pd = self._rungs(self._window_pd, headroom)
            calm_r = ladder_ceil(int(np.ceil(
                float(self._window_in.max()) * headroom))) \
                if self._window_in.max() > 0 else 0
            self._window_pd = np.zeros(self.n_shards, np.int64)
            self._window_in = np.zeros(self.n_shards, np.int64)
            self._obs_pd = 0
            if (calm_pd < self.grants).any() or calm_r < self.recv_grant:
                self.grants = np.minimum(self.grants, calm_pd)
                self.recv_grant = min(self.recv_grant, calm_r)
                changed_pd = True
        return changed, changed_pd

    def snapshot(self) -> Dict[str, Any]:
        return {"grant": self.grant,
                "grants": None if self.grants is None
                else self.grants.tolist(),
                "recv_grant": self.recv_grant,
                "peak_need": self.peak.tolist(),
                "peak_inbound": self.peak_inbound.tolist(),
                "observations": self.observations}


def _zeros_like_need(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(2 * n, dtype=torch.int32, device=device)


class ShardExchange:
    """Per-engine exchange plane: plans each batch's layout, runs K23/K24,
    and holds the counters and demand estimators the engine drains at
    quiescence."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.mesh = engine.mesh
        self.axis = engine.config.mesh_axis
        self.n_shards = engine.n_shards
        self.device = engine.device
        # disengaged-probe pacing, per site (one global clock would alias
        # with the per-tick group rotation)
        self._probe_clocks: Dict[Site, int] = {}
        # cumulative stats (folded from the device at drain points)
        self.exchanges_run = 0
        self.cross_shard_msgs = 0
        self.delivered_msgs = 0
        self.dropped_msgs = 0
        self.redeliveries = 0
        self.exchange_seconds = 0.0
        # bucket utilization: logical input lanes over padded output lanes
        self.live_lanes = 0
        self.padded_lanes = 0
        # overlap: host wall pre-dispatched exchanges waited under other
        # work before their group used them
        self.overlap_seconds = 0.0
        self.overlap_hits = 0
        self.pre_discards = 0
        # occupancy-sized caps: per-site estimators and a version the
        # fused plan signature watches (any grant move rebuilds a window,
        # cause bucket_growth)
        self.estimators: Dict[Site, _SiteEstimator] = {}
        self.cap_version = 0
        # the distinct exchange layouts run (the JAX compile cache's keys)
        self._plans: set = set()
        # widths this plane produced (exchange outputs, aligned layouts):
        # only these keep their exact per-block split in plan()
        self._transport_widths: set = set()
        # layouts seen per (L, shard_capacity, leaves): a new cap for a
        # seen shape is a re-quantization, counted
        self._seen_shapes: Dict[Tuple[int, int, int], set] = {}
        self.requantizations = 0
        # fused builds read this: (site, lanes in, lanes out) of every
        # exchange the window's discovery pass ran
        self.trace_log: List[Tuple[Site, int, int]] = []

    def adopt_stats(self, prev: "Optional[ShardExchange]") -> None:
        """Carry the cumulative counters (and, at the same block count,
        the demand estimators) over from an earlier plane."""
        if prev is None:
            return
        for name in ("exchanges_run", "cross_shard_msgs", "delivered_msgs",
                     "dropped_msgs", "redeliveries", "exchange_seconds",
                     "live_lanes", "padded_lanes", "overlap_seconds",
                     "overlap_hits", "pre_discards", "requantizations"):
            setattr(self, name, getattr(prev, name))
        self.cap_version = prev.cap_version + 1
        if prev.n_shards == self.n_shards:
            self.estimators = prev.estimators
            self._transport_widths = set(prev._transport_widths)

    # -- engagement ---------------------------------------------------------

    def engaged(self) -> bool:
        """Whether the structured exchange runs at all: "always" and
        "never" force it; "auto" engages it only when the mesh's blocks
        span more than one device (see the module note)."""
        mode = self.engine.config.exchange_structured
        if mode == "always":
            return True
        if mode == "never":
            return False
        return self.mesh is not None and self.mesh.spans_devices()

    def note_transport_width(self, w: int) -> None:
        self._transport_widths.add(int(w))

    def probe_scale(self, site: Site, interval: int) -> int:
        """Advance the site's probe clock: 0 = not probed this time, else
        the number of occurrences the probe stands for (the first
        occurrence always probes, at scale 1)."""
        pending = self._probe_clocks.get(site)
        if pending is None:
            self._probe_clocks[site] = 0
            return 1
        pending += 1
        if pending >= max(1, interval):
            self._probe_clocks[site] = 0
            return pending
        self._probe_clocks[site] = pending
        return 0

    def _chunk_lanes(self, m: int) -> int:
        n = self.n_shards
        return m // n if m in self._transport_widths and m % n == 0 \
            else ladder_ceil(-(-m // n))

    def _probe(self, arena, rows: torch.Tensor, mask: torch.Tensor,
               site: Site) -> torch.Tensor:
        """Measure-only classification of a disengaged exchange (K23 probe
        mode): the int32 [3 + 2n] stats, still on the device; the batch
        itself delivers untouched."""
        L = self._chunk_lanes(int(rows.shape[0]))
        return exchange_classify(_rows32(rows), _mask_bool(mask, rows),
                                 int(arena.shard_capacity), L,
                                 self.n_shards, "probe")

    # -- occupancy-sized planning ---------------------------------------------

    def observe_need(self, site: Site, need: np.ndarray,
                     inbound: Optional[np.ndarray] = None) -> None:
        """Fold one drained per-destination demand vector (a [2n] vector
        splits into max-half and sum-half)."""
        cfg = self.engine.config
        need = np.asarray(need)
        n = self.n_shards
        if inbound is None and need.shape[0] == 2 * n:
            need, inbound = need[:n], need[n:]
        est = self.estimators.get(site)
        if est is None:
            est = self.estimators[site] = _SiteEstimator(n)
        changed, changed_pd = est.observe(
            need, cfg.exchange_headroom, cfg.exchange_shrink_patience,
            inbound=inbound)
        # a per-dest-only rung move is invisible to a "never" run's plans
        if changed or (changed_pd and cfg.exchange_per_dest != "never"):
            self.cap_version += 1

    def grant_for(self, site: Optional[Site]) -> Optional[int]:
        if site is None or not self.engine.config.exchange_occupancy_sizing:
            return None
        est = self.estimators.get(site)
        return None if est is None else est.grant

    def grants_for(self, site: Optional[Site]
                   ) -> Optional[Tuple[np.ndarray, int]]:
        if site is None or not self.engine.config.exchange_occupancy_sizing:
            return None
        est = self.estimators.get(site)
        if est is None or est.grants is None:
            return None
        return est.grants, int(est.recv_grant or 0)

    def plan(self, m: int, site: Optional[Site] = None) -> Tuple[int, int]:
        """(lanes per chunk L, per-(source, destination) cap) for an
        m-lane batch, both on the ladder; cap ≤ L.  A measured site uses
        its grant, an unmeasured one the worst-case formula.  A width this
        plane produced keeps its exact split (re-quantizing would shift
        lanes out of their home chunks)."""
        n = self.n_shards
        cfg = self.engine.config
        L = self._chunk_lanes(m)
        grant = self.grant_for(site)
        if grant is not None:
            return L, min(L, grant)
        cap = min(L, pow2ceil(max(
            int(cfg.exchange_pad_quantum),
            int(L / n * cfg.exchange_capacity_factor))))
        return L, cap

    def plan_ex(self, m: int, site: Optional[Site] = None):
        """``("legacy", L, cap, None)`` or ``("perdest", L, cap, (caps,
        R))``: ``exchange_per_dest="auto"`` takes the per-destination
        layout only when it is narrower than the legacy one."""
        L, cap = self.plan(m, site=site)
        mode = self.engine.config.exchange_per_dest
        if mode == "never":
            return ("legacy", L, cap, None)
        pd = self.grants_for(site)
        if pd is None:
            return ("legacy", L, cap, None)
        grants, recv = pd
        caps = np.minimum(grants, L).astype(np.int64)
        if caps.max() == 0 or cap == 0:
            return ("legacy", L, cap, None)
        n = self.n_shards
        R = max(1, ladder_ceil(min(int(recv), n * L)))
        S = int(caps.sum())
        if mode != "always" and S + R >= 2 * n * cap:
            return ("legacy", L, cap, None)
        return ("perdest", L, cap, (tuple(int(c) for c in caps), R))

    def plan_signature(self, sites) -> Tuple:
        """What a fused window's exchange plans depend on: engagement, the
        sizing knobs and the grants of the sites it exchanges; a window
        rebuilds when it moves (cause ``bucket_growth``)."""
        cfg = self.engine.config
        mode = cfg.exchange_per_dest

        def pd_sig(s):
            if mode == "never":
                return None
            pd = self.grants_for(s)
            return None if pd is None else (tuple(pd[0].tolist()), pd[1])
        return (self.engaged(),
                bool(cfg.exchange_occupancy_sizing),
                mode,
                int(cfg.exchange_pad_quantum),
                float(cfg.exchange_capacity_factor),
                tuple((s, self.grant_for(s), pd_sig(s))
                      for s in sorted(sites)))

    # -- host-side alignment ------------------------------------------------

    def align_plan(self, rows_np: np.ndarray, shard_capacity: int,
                   quantum: int = 16) -> Optional[Dict[str, Any]]:
        """Pack a known row set home-block-local on the host: lanes are
        permuted so chunk s of the padded batch holds only rows of block
        s, and the window's exchange of this source plans cap 0.  ``take``
        maps aligned lane → original lane (-1 = padding); the per-chunk
        width is a multiple of ``quantum``.  None when a row is
        invalid."""
        rows_np = np.asarray(rows_np)
        if rows_np.ndim != 1 or rows_np.size == 0 or (rows_np < 0).any():
            return None
        n = self.n_shards
        dest = rows_np // int(shard_capacity)
        if (dest >= n).any():
            return None
        counts = np.bincount(dest, minlength=n)
        La = max(quantum, -(-int(counts.max()) // quantum) * quantum)
        take = np.full(n * La, -1, np.int64)
        order = np.argsort(dest, kind="stable")
        off = 0
        for s in range(n):
            lanes = order[off:off + counts[s]]
            take[s * La:s * La + len(lanes)] = lanes
            off += counts[s]
        rows_aligned = np.where(take >= 0, rows_np[np.clip(take, 0, None)],
                                -1).astype(np.int32)
        return {"L": La, "m": int(rows_np.size),
                "take": take.astype(np.int32), "rows": rows_aligned}

    # -- the exchange bodies --------------------------------------------------

    def _traced(self, rows: torch.Tensor, leaves: List[torch.Tensor],
                mask: torch.Tensor, shard_capacity: int, L: int, cap: int):
        """The legacy exchange at padded size ``n * L``: ``(rows, leaves,
        mask, dropped[m], stats[3 + 2n])``.  ``cap == 0`` is the
        classification-only path (K23 cap-0 mode: local lanes stay in
        place, every cross lane drops, output width = input width); any
        other cap runs K24."""
        n = self.n_shards
        if cap == 0:
            out_rows, local, cross, stats = exchange_classify(
                rows, mask, shard_capacity, L, n, "cap0")
            leaves = [_pad_lanes(x, n * L) for x in leaves]
            return out_rows, leaves, local, cross[:rows.shape[0]], stats
        return exchange_buckets(rows, mask, leaves, shard_capacity, L, n,
                                cap=cap)

    def _traced_perdest(self, rows: torch.Tensor,
                        leaves: List[torch.Tensor], mask: torch.Tensor,
                        shard_capacity: int, L: int,
                        caps: Tuple[int, ...], R: int):
        """The per-destination exchange (K24 with ``caps`` and the receive
        rung ``R``): the same contract as ``_traced``."""
        return exchange_buckets(rows, mask, leaves, shard_capacity, L,
                                self.n_shards, caps=caps, R=R)

    # -- fused-window entry ---------------------------------------------------

    def apply_traced(self, site: Site, shard_capacity: int,
                     rows: torch.Tensor, args: Any, mask: torch.Tensor):
        """The exchange inside a fused window: ``(rows2, args2, mask2,
        dropped_count, need)`` with the dropped count (an int32 device
        scalar, joined to the window's miss counter) and ``need`` (int32
        [2n] on the device, max-merged into the window's demand
        accumulator).  Args that are not lane-aligned pass through
        untouched.  A cap-0 plan takes the lean path: K23 classification
        and the miss count only, a zero need."""
        m = rows.shape[0]
        n = self.n_shards
        dev = rows.device
        if not exchangeable_args(args, m):
            return (rows, args, mask, torch.zeros((), dtype=torch.int32,
                                                  device=dev),
                    _zeros_like_need(n, dev))
        rows, mask = _rows32(rows), _mask_bool(mask, rows)
        mode, L, cap, pd = self.plan_ex(m, site=site)
        leaves = _split_leaves(args, m, dev)
        if cap == 0:
            out_rows, local, _cross, stats = exchange_classify(
                rows, mask, shard_capacity, L, n, "cap0")
            args2 = _join_leaves(args, [_pad_lanes(x, n * L)
                                        for x in leaves])
            self.trace_log.append((site, int(m), n * L))
            self.note_transport_width(n * L)
            return (out_rows, args2, local, stats[1],
                    _zeros_like_need(n, dev))
        if mode == "perdest":
            caps, R = pd
            rows2, leaves2, mask2, _dropped, stats = self._traced_perdest(
                rows, leaves, mask, shard_capacity, L, caps, R)
        else:
            rows2, leaves2, mask2, _dropped, stats = self._traced(
                rows, leaves, mask, shard_capacity, L, cap)
        self.trace_log.append((site, int(m), int(rows2.shape[0])))
        self.note_transport_width(int(rows2.shape[0]))
        return rows2, _join_leaves(args, leaves2), mask2, stats[1], stats[3:]

    # -- unfused entry --------------------------------------------------------

    def dispatch(self, arena, rows: torch.Tensor, args: Any,
                 mask: torch.Tensor, site: Optional[Site] = None,
                 defer_stats: bool = False):
        """One exchange of an unfused batch: ``(rows2, args2, mask2,
        dropped[m], stats)``, the dropped mask and the int32 [3 + 2n]
        stats still on the device — the engine parks them and reads every
        parked check with one copy at the next drain.  ``defer_stats``
        (the round-start pre-dispatch) appends a run-cost tuple and folds
        no counters: its consumer folds them (``fold_dispatch``) or drops
        them with a stale result, so a batch counts once."""
        t0 = time.perf_counter()
        m = int(rows.shape[0])
        shard_capacity = int(arena.shard_capacity)
        dev = rows.device
        rows, mask = _rows32(rows), _mask_bool(mask, rows)
        mode, L, cap, pd = self.plan_ex(m, site=site)
        leaves = _split_leaves(args, m, dev)
        if mode == "perdest":
            caps, R = pd
            layout = ("pd", caps, R)
            label = f"pd{sum(caps)}r{R}"
        else:
            layout, label = cap, str(cap)
        key = (L, layout, shard_capacity, len(leaves))
        if key not in self._plans:
            self._plans.add(key)
            seen = self._seen_shapes.setdefault(
                (L, shard_capacity, len(leaves)), set())
            if seen:
                # same batch shape, new cap: the estimate re-quantized
                self.requantizations += 1
            seen.add(label)
        if mode == "perdest":
            rows2, leaves2, mask2, dropped, stats = self._traced_perdest(
                rows, leaves, mask, shard_capacity, L, caps, R)
        else:
            rows2, leaves2, mask2, dropped, stats = self._traced(
                rows, leaves, mask, shard_capacity, L, cap)
        args2 = _join_leaves(args, leaves2)
        self.note_transport_width(int(rows2.shape[0]))
        if defer_stats:
            return rows2, args2, mask2, dropped, stats, \
                (m, int(rows2.shape[0]), time.perf_counter() - t0)
        self.exchanges_run += 1
        self.live_lanes += m
        self.padded_lanes += int(rows2.shape[0])
        self.exchange_seconds += time.perf_counter() - t0
        return rows2, args2, mask2, dropped, stats

    def fold_dispatch(self, run_cost: Tuple[int, int, float]) -> None:
        """Fold a deferred pre-dispatch's run counters when it is used."""
        m, padded, dt = run_cost
        self.exchanges_run += 1
        self.live_lanes += m
        self.padded_lanes += padded
        self.exchange_seconds += dt

    def fold_stats(self, stats_host: np.ndarray, site: Optional[Site] = None,
                   scale: int = 1) -> None:
        """Accumulate one drained stats vector; its demand tail feeds the
        site's estimator.  ``scale > 1`` marks a sampled probe: the counts
        multiply up (the demand tail is a peak and never scales)."""
        self.cross_shard_msgs += int(stats_host[0]) * scale
        self.dropped_msgs += int(stats_host[1]) * scale
        self.delivered_msgs += int(stats_host[2]) * scale
        if site is not None and len(stats_host) > 3:
            self.observe_need(site, np.asarray(stats_host[3:]))

    def fold_fused_shapes(self, shapes, n_ticks: int) -> None:
        """Account a fused window run's in-window exchanges (their widths
        were captured at build time)."""
        for _site, m_in, m_out in shapes:
            self.exchanges_run += n_ticks
            self.live_lanes += m_in * n_ticks
            self.padded_lanes += m_out * n_ticks

    def note_overlap(self, seconds: float) -> None:
        self.overlap_seconds += max(0.0, seconds)
        self.overlap_hits += 1

    def utilization(self) -> float:
        """Live input lanes over padded output lanes."""
        return self.live_lanes / self.padded_lanes \
            if self.padded_lanes else 1.0

    def cap_gauges(self) -> Dict[int, int]:
        """Per destination block, the ladder rung of the measured peak
        demand, maxed over sites."""
        cfg = self.engine.config
        out = {s: 0 for s in range(self.n_shards)}
        for est in self.estimators.values():
            for s in range(self.n_shards):
                rung = ladder_ceil(int(np.ceil(
                    float(est.peak[s]) * cfg.exchange_headroom)))
                out[s] = max(out[s], rung)
        return out

    def cap_util_gauges(self) -> Dict[int, float]:
        """Per destination block, the last drained demand over the current
        per-destination grant, maxed over sites."""
        out = {s: 0.0 for s in range(self.n_shards)}
        for est in self.estimators.values():
            if est.grants is None:
                continue
            for s in range(self.n_shards):
                if est.grants[s] > 0:
                    util = float(est.last_need[s]) / float(est.grants[s])
                    out[s] = max(out[s], round(util, 4))
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "n_shards": self.n_shards,
            "engaged": self.engaged(),
            "exchanges_run": self.exchanges_run,
            "cross_shard_msgs": self.cross_shard_msgs,
            "delivered_msgs": self.delivered_msgs,
            "dropped_msgs": self.dropped_msgs,
            "redeliveries": self.redeliveries,
            "exchange_seconds": round(self.exchange_seconds, 6),
            "compiled_programs": len(self._plans),
            "requantizations": self.requantizations,
            "bucket_utilization": round(self.utilization(), 4),
            "overlap_seconds": round(self.overlap_seconds, 6),
            "overlap_hits": self.overlap_hits,
            "pre_discards": self.pre_discards,
            "cap_version": self.cap_version,
            "sites": {f"{t}.{m}": est.snapshot()
                      for (t, m), est in self.estimators.items()},
        }


# -- payload trees --------------------------------------------------------------

def exchangeable_args(args: Any, m: int) -> bool:
    """True when every non-scalar leaf of ``args`` is lane-aligned ([m,
    ...]), the precondition for permuting lanes."""
    return all(is_scalar_leaf(leaf) or np.shape(leaf)[0] == m
               for leaf in tree_leaves(args))


def _split_leaves(args: Any, m: int, device: torch.device
                  ) -> List[torch.Tensor]:
    """The exchangeable ([m, ...]) leaves of ``args`` as contiguous
    tensors on ``device``, in walk order; scalar leaves bypass the
    exchange."""
    out: List[torch.Tensor] = []
    for i, leaf in enumerate(tree_leaves(args)):
        if is_scalar_leaf(leaf):
            continue
        if np.shape(leaf)[0] != m:
            raise ValueError(f"exchange: arg leaf {i} has leading dim "
                             f"{np.shape(leaf)[0]}, batch has {m} lanes")
        if not isinstance(leaf, torch.Tensor):
            a = np.asarray(leaf)
            if a.dtype == np.int64:
                a = a.astype(np.int32)
            elif a.dtype == np.float64:
                a = a.astype(np.float32)
            leaf = torch.from_numpy(np.ascontiguousarray(a))
        out.append(leaf.to(device).contiguous())
    return out


def _join_leaves(args: Any, leaves: List[torch.Tensor]) -> Any:
    """``args`` with its non-scalar leaves replaced, in walk order."""
    return tree_replace(args, leaves)


def _pad_lanes(x: torch.Tensor, total: int) -> torch.Tensor:
    """Zero-pad a lane-aligned leaf to ``total`` lanes."""
    if x.shape[0] == total:
        return x
    return torch.cat([x, x.new_zeros((total - x.shape[0], *x.shape[1:]))])


def _rows32(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype != torch.int32:
        rows = rows.to(torch.int32)
    return rows.contiguous()


def _mask_bool(mask: Optional[torch.Tensor], rows: torch.Tensor
               ) -> torch.Tensor:
    if mask is None:
        return torch.ones(rows.shape[0], dtype=torch.bool,
                          device=rows.device)
    if mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    return mask.contiguous()
