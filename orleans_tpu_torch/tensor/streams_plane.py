"""DeviceSubscriptions: the streams layer's pub-sub adjacency on the device.

The port of ``orleans_tpu/tensor/streams_plane.py``.  Orleans' streams
core (pub-sub over grains: PubSubRendezvous holds each stream's
subscriber set, pulling agents deliver one grain call per (event,
consumer)) becomes a stream→subscriber graph on the card, kept under the
arena's generation / eviction-epoch discipline, and a whole tick's
published events fan out to every subscriber at once.

Two device layouts, one host truth (the sorted unique edge table):

* **pull (the fast path)**: edges grouped by SUBSCRIBER ARENA ROW with
  row-aligned offsets (int32 ``[capacity + 1]``), built against a BOUND
  publish key set (``bind``, the steady injector pattern) and stamped
  with the subscriber arena's ``(generation, eviction_epoch)``.  A
  delivery is one gather of the published payload per edge
  (``src_lane`` indexes the bound key set) and a row-range reduction in
  the subscriber's handler (K16) — no resolution, no scatter.
* **push (the general path)**: edges grouped by STREAM, expanded to
  subscriber KEYS by K11 (``kernels/fanout.py``, shared with
  ``DeviceFanout``) for any other publish batch; the deliveries resolve
  like any emit, so an evicted subscriber re-activates (the reference's
  deliver-reactivates semantics).  Overflowing source lanes park with a
  device-side dropped mask and redeliver with their original stamp.

Churn discipline:

* subscribe / unsubscribe buffer host mutations that merge, vectorized,
  at the next rebuild; a mutation settles the engine's auto-fusion chain
  first, so a rolled-back window replays under the adjacency its ticks
  were consumed with;
* the arena's deactivation path calls ``on_evict`` before the victims'
  rows return to the free list: a subscribed victim dirties the pull
  layout (the next publish rebuilds, and a reused row can never receive
  the dead subscription's events); otherwise the stamp adopts the epoch
  the caller is about to bump, and no rebuild is paid;
* rows that move (growth, compaction) bump the generation, so the stamp
  no longer matches and the next publish rebuilds.

Each rebuild allocates new layout tensors and bumps ``layout_version``:
a fused window bakes their addresses and rebuilds when the engine's
route signature moves.  The window warms every layout before it
captures; a rebuild while a CUDA graph is capturing raises.  The JAX
module's guard against rebuilding under a trace has no other
counterpart.  The layouts hold copies of everything the caller hands
over (edge arrays, the bound key set), since the caller may rewrite its
arrays afterwards.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.device import host_upload
from orleans_tpu_torch.kernels.fanout import fanout_expand
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.tensor.engine import _gather_lanes, _map_tree
from orleans_tpu_torch.tensor.vector_grain import ones_mask


def _host_keys(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.int64).reshape(-1)


def _as_pairs(streams, subs) -> np.ndarray:
    """(stream, subscriber) pairs as a new int64 ``[n, 2]`` array."""
    s = _host_keys(streams)
    d = _host_keys(subs)
    if s.shape != d.shape:
        if s.size == 1:
            s = np.broadcast_to(s, d.shape)
        elif d.size == 1:
            d = np.broadcast_to(d, s.shape)
        else:
            raise ValueError("streams/subscribers length mismatch")
    pairs = np.stack([s, d], axis=1)
    if pairs.size and (pairs.min() < 0
                       or pairs.max() >= np.int64(KEY_SENTINEL)):
        raise OverflowError(
            "stream and subscriber keys must be in [0, 2**31-1) — the "
            "device CSR is int32-keyed (hash wider identities in)")
    return pairs


def _pair_diff(base: np.ndarray, remove: np.ndarray) -> np.ndarray:
    """base \\ remove over ``[N, 2]`` pair arrays: both columns are int31,
    so a pair packs losslessly into one int64 (``s << 31 | d``)."""
    if len(base) == 0 or len(remove) == 0:
        return base
    pack = base[:, 0] << np.int64(31) | base[:, 1]
    rpack = remove[:, 0] << np.int64(31) | remove[:, 1]
    return base[~np.isin(pack, rpack, assume_unique=False)]


def _check_not_capturing(what: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"streams plane: the {what} layout is stale during a CUDA graph "
            f"capture; a fused window warms every layout before it "
            f"captures, so a row or adjacency change bypassed the window's "
            f"rebuild check")


class DeviceSubscriptions:
    """One stream→subscriber adjacency bound to a subscriber delivery edge
    (``dst_interface.dst_method``), registered on the engine with
    ``engine.register_subscriptions(src_iface, src_method, subs)``: every
    message applied to the stream-ingress method also fans out to the
    stream's subscribers."""

    def __init__(self, engine, dst_interface, dst_method: str) -> None:
        self.engine = weakref.ref(engine) if engine is not None else None
        self.type_name = dst_interface if isinstance(dst_interface, str) \
            else dst_interface.__name__
        self.method = dst_method
        # host truth: [E, 2] (stream_key, sub_key) pairs, sorted unique;
        # mutations buffer and merge at the next rebuild
        self._edges = np.empty((0, 2), dtype=np.int64)
        self._pending_add: List[np.ndarray] = []
        self._pending_remove: List[np.ndarray] = []
        self._sub_keys_sorted = np.empty(0, dtype=np.int64)
        #: bumped on every device-layout rebuild (new tensors)
        self.layout_version = 0
        #: bumped on every buffered mutation batch (rebuilds are lazy)
        self.mutation_version = 0
        self._host_dirty = False
        self._push_dirty = True
        self._pull_dirty = True
        # push CSR on the host (stream keys, offsets, dst keys) and its
        # device copies, one per device
        self._push_host: Optional[Tuple[np.ndarray, ...]] = None
        self._push: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        # (n_dropped, src_dropped) of each expand, popped by take_drop()
        self._pending_drops: List[Tuple[torch.Tensor, torch.Tensor]] = []
        # pull layout against the bound publish key set (a copy)
        self._bound_keys: Optional[np.ndarray] = None
        self._bound_digest: Optional[Tuple[int, int]] = None
        self._pull: Optional[Dict[str, Any]] = None
        self._pull_stamp: Tuple[int, int] = (-1, -1)
        self._pull_live_count = -1
        self._cold_count = 0
        # host-side stats (the stream.* metric feed)
        self.published_events = 0
        self.delivered_events = 0
        self.pull_deliveries = 0
        self.push_deliveries = 0
        self.rebuilds = 0
        self.retired_edges = 0
        self.dropped_lanes = 0
        self.redeliveries = 0

    # -- control plane (host mutations, batched) -----------------------------

    def _settle_engine_chain(self) -> None:
        """A mutation settles the engine's open auto-fusion verification
        chain first: a rollback then replays its ticks under the adjacency
        they were consumed with."""
        engine = self.engine() if self.engine is not None else None
        if engine is not None and engine.autofuser._unverified:
            engine.autofuser._settle_chain()

    def subscribe(self, stream_key: int, sub_key: int) -> None:
        self.subscribe_many([stream_key], [sub_key])

    def unsubscribe(self, stream_key: int, sub_key: int) -> None:
        self.unsubscribe_many([stream_key], [sub_key])

    def subscribe_many(self, stream_keys, sub_keys) -> None:
        pairs = _as_pairs(stream_keys, sub_keys)
        if len(pairs) == 0:
            return
        self._settle_engine_chain()
        self._pending_add.append(pairs)
        self._mark_mutated()

    def unsubscribe_many(self, stream_keys, sub_keys) -> None:
        pairs = _as_pairs(stream_keys, sub_keys)
        if len(pairs) == 0:
            return
        self._settle_engine_chain()
        self._pending_remove.append(pairs)
        self._mark_mutated()

    def _mark_mutated(self) -> None:
        self.mutation_version += 1
        self._host_dirty = True
        self._push_dirty = True
        self._pull_dirty = True

    def _merge_host(self) -> None:
        """Fold the buffered mutation batches into the edge table in one
        vectorized merge (removes apply after adds, so an add and a remove
        of one edge in one churn window net to absent)."""
        if not self._host_dirty:
            return
        edges = self._edges
        if self._pending_add:
            edges = np.unique(
                np.concatenate([edges] + self._pending_add), axis=0)
            self._pending_add = []
        if self._pending_remove:
            edges = _pair_diff(
                edges, np.unique(np.concatenate(self._pending_remove),
                                 axis=0))
            self._pending_remove = []
        self._edges = edges
        self._sub_keys_sorted = np.unique(edges[:, 1])
        self._host_dirty = False

    def edges(self) -> np.ndarray:
        """The merged ``[E, 2]`` (stream, subscriber) edge table — the host
        truth the exactness oracles replay against."""
        self._merge_host()
        return self._edges

    @property
    def edge_count(self) -> int:
        self._merge_host()
        return len(self._edges)

    def subscribers_of(self, stream_key: int) -> np.ndarray:
        e = self.edges()
        lo = np.searchsorted(e[:, 0], stream_key, side="left")
        hi = np.searchsorted(e[:, 0], stream_key, side="right")
        return e[lo:hi, 1].copy()

    def host_expand(self, stream_keys: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(subscriber keys, source lane) of a publish batch, on the host:
        the oracle's replay and the plane-disabled path share it."""
        e = self.edges()
        keys = np.asarray(stream_keys, dtype=np.int64)
        lo = np.searchsorted(e[:, 0], keys, side="left")
        hi = np.searchsorted(e[:, 0], keys, side="right")
        deg = hi - lo
        src_idx = np.repeat(np.arange(len(keys)), deg)
        ranges = [np.arange(a, b) for a, b in zip(lo, hi) if b > a]
        edge_ix = np.concatenate(ranges) if ranges \
            else np.empty(0, dtype=np.int64)
        return e[edge_ix, 1], src_idx

    # -- eviction retirement (the arena hook) --------------------------------

    def on_evict(self, arena, victims: np.ndarray,
                 keys: np.ndarray) -> None:
        """Called by the subscriber arena's deactivation path BEFORE the
        victims' rows return to the free list.  A subscribed victim dirties
        the pull layout (rebuilt at the next publish); otherwise the stamp
        adopts the epoch the caller bumps after this hook (rows holding
        edges were untouched, so the layout stays exactly valid)."""
        if arena.info.name != self.type_name:
            return
        self._merge_host()
        if len(self._sub_keys_sorted) == 0:
            return
        idx = np.searchsorted(self._sub_keys_sorted, keys)
        idx = np.minimum(idx, len(self._sub_keys_sorted) - 1)
        hit = self._sub_keys_sorted[idx] == keys
        if hit.any():
            evicted = keys[hit]
            self.retired_edges += int(np.isin(self._edges[:, 1],
                                              evicted).sum())
            self._pull_dirty = True
            # the push CSR holds KEYS, not rows: eviction does not stale it
        elif self._pull is not None \
                and self._pull_stamp == (arena.generation,
                                         arena.eviction_epoch):
            self._pull_stamp = (arena.generation, arena.eviction_epoch + 1)

    def on_migrate(self, arena, keys: np.ndarray) -> None:
        """Called by the subscriber arena's live migration (rows move,
        grains stay live): unlike eviction the subscriptions survive — the
        host truth and the key-addressed push CSR stand — but the pull
        layout addresses subscriber rows, so a migrated subscribed key
        dirties it for a rebuild at the next publish.  With no subscribed
        mover only the stamp advances (the caller bumps the epoch after
        this hook)."""
        if arena.info.name != self.type_name:
            return
        self._merge_host()
        if len(self._sub_keys_sorted) == 0:
            return
        keys = np.asarray(keys, dtype=np.int64)
        idx = np.searchsorted(self._sub_keys_sorted, keys)
        idx = np.minimum(idx, len(self._sub_keys_sorted) - 1)
        if (self._sub_keys_sorted[idx] == keys).any():
            self._pull_dirty = True
        elif self._pull is not None \
                and self._pull_stamp == (arena.generation,
                                         arena.eviction_epoch):
            self._pull_stamp = (arena.generation, arena.eviction_epoch + 1)

    # -- pull layout (the bound fast path) ------------------------------------

    def bind(self, publish_keys) -> None:
        """Declare the steady publish key set (the injector's pattern).
        Publishes carrying exactly this key set take the pull path.  The
        plane keeps a copy."""
        keys = np.array(_host_keys(publish_keys), dtype=np.int64)
        if len(keys) != len(np.unique(keys)):
            raise ValueError("bound publish keys must be unique")
        self._bound_keys = keys
        self._bound_digest = (len(keys), hash(keys.tobytes()))
        self._pull_dirty = True

    def _matches_bound(self, keys_host: Optional[np.ndarray]) -> bool:
        if self._bound_keys is None or keys_host is None:
            return False
        if len(keys_host) != len(self._bound_keys):
            return False
        keys = np.asarray(keys_host, dtype=np.int64)
        return (len(keys), hash(keys.tobytes())) == self._bound_digest

    def _rebuild_pull(self, arena) -> None:
        """Lay the pull layout out against the CURRENT key→row map in one
        vectorized pass: resolve the subscribers of bound streams, group
        the live edges by row, emit the row-aligned offsets.  Subscribers
        not live now are COLD: the plane takes the push path (whose
        delivery re-activates them) and re-checks when the live count
        moves."""
        _check_not_capturing("pull")
        edges = self.edges()
        bound = self._bound_keys
        cap = arena.capacity
        # edges of streams outside the bound set never receive from this
        # pattern: they stay push-only
        in_bound = np.isin(edges[:, 0], bound) if len(edges) else \
            np.zeros(0, bool)
        sel = edges[in_bound]
        rows, found = arena.lookup_rows(sel[:, 1]) if len(sel) else (
            np.empty(0, np.int32), np.empty(0, bool))
        self._cold_count = int((~found).sum())
        live = sel[found]
        live_rows = rows[found].astype(np.int64)
        order = np.argsort(live_rows, kind="stable")
        live = live[order]
        live_rows = live_rows[order]
        # per-edge source lane: the edge's stream's position in the bound
        # key set
        bsort = np.argsort(bound, kind="stable")
        pos = np.searchsorted(bound[bsort], live[:, 0])
        lanes = bsort[np.minimum(pos, len(bound) - 1)] if len(bound) \
            else np.zeros(len(live), np.int64)
        counts = np.bincount(live_rows, minlength=cap) if len(live) \
            else np.zeros(cap, np.int64)
        offsets = np.zeros(cap + 1, dtype=np.int32)
        offsets[1:] = np.cumsum(counts)
        dev = arena.device
        self._pull = {
            "rows": host_upload(live_rows.astype(np.int32), dev),
            # subscriber KEYS per edge: the stale-batch fallback address
            "dst_key": host_upload(live[:, 1].astype(np.int32), dev),
            "offsets": host_upload(offsets, dev),
            "src_lane": host_upload(lanes.astype(np.int32), dev),
            "src_key": host_upload(live[:, 0].astype(np.int32), dev),
            "n_edges": len(live),
        }
        self._pull_stamp = (arena.generation, arena.eviction_epoch)
        self._pull_live_count = arena.live_count
        self._pull_dirty = False
        self.layout_version += 1
        self.rebuilds += 1

    def pull_layout(self, arena) -> Optional[Dict[str, Any]]:
        """The current pull layout when it is exactly valid (bound, warm,
        stamps current); None → the caller takes the push path.  A cold
        layout re-checks when the arena's live count moves, so a push
        delivery's re-activation brings the next publish back to the pull
        path."""
        if self._bound_keys is None:
            return None
        if self._pull_dirty or self._pull is None \
                or self._pull_stamp != (arena.generation,
                                        arena.eviction_epoch) \
                or (self._cold_count > 0
                    and self._pull_live_count != arena.live_count):
            self._rebuild_pull(arena)
        if self._cold_count > 0:
            return None
        return self._pull

    # -- push CSR (the general path) -----------------------------------------

    def _rebuild_push(self) -> None:
        _check_not_capturing("push")
        edges = self.edges()
        streams, starts = np.unique(edges[:, 0], return_index=True) \
            if len(edges) else (np.empty(0, np.int64),
                                np.empty(0, np.int64))
        width = max(256, -(-max(1, len(edges)) // 256) * 256)
        dst = np.full(width, KEY_SENTINEL, np.int32)
        if len(streams) == 0:
            # a sentinel row, so K11 never searches an empty array
            keys = np.array([KEY_SENTINEL], np.int32)
            offsets = np.zeros(2, np.int32)
        else:
            keys = streams.astype(np.int32)
            offsets = np.concatenate([starts, [len(edges)]]).astype(np.int32)
            dst[:len(edges)] = edges[:, 1].astype(np.int32)
        self._push_host = (keys, offsets, dst)
        self._push = {}
        self._push_dirty = False
        self.layout_version += 1
        self.rebuilds += 1

    def push_csr(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``(stream keys, offsets, dst keys)`` on ``device``, rebuilt first
        when the adjacency changed."""
        if self._push_dirty or self._push_host is None:
            self._rebuild_push()
        out = self._push.get(device)
        if out is None:
            _check_not_capturing("push")
            out = self._push[device] = tuple(
                host_upload(a, device) for a in self._push_host)
        return out

    def expand(self, src_keys: torch.Tensor, args: Any,
               mask: Optional[torch.Tensor] = None,
               n_dropped: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
        """Push-path expansion, the ``DeviceFanout`` contract: (subscriber
        keys [W], args gathered per slot plus ``src_key``, valid mask [W]);
        overflowing source lanes wait for ``take_drop()``.  Given
        ``n_dropped``, their count adds into it (a fused window's miss
        total)."""
        ck, co, cd = self.push_csr(src_keys.device)
        if mask is None:
            mask = ones_mask(src_keys.shape[0], src_keys.device)
        dst, src_index, out_valid, _total, src_dropped, count = \
            fanout_expand(ck, co, cd, src_keys, mask, n_dropped)
        self._pending_drops.append((count, src_dropped))
        gathered = _map_tree(lambda a: _gather_lanes(a, src_index), args)
        if isinstance(gathered, dict) and "src_key" not in gathered:
            gathered = {**gathered, "src_key": _gather_lanes(src_keys, src_index)}
        return dst, gathered, out_valid

    def take_drop(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_dropped, src_dropped) of the expand() that just ran — the
        engine parks them like a fan-out check."""
        return self._pending_drops.pop()

    def overflow_check(self) -> int:
        """Read the un-taken parked drop counts, fold them into
        ``dropped_lanes`` and return their total."""
        drops, self._pending_drops = self._pending_drops, []
        total = sum(int(n) for n, _mask in drops)
        self.dropped_lanes += total
        return total

    # -- stats ----------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "dst": f"{self.type_name}.{self.method}",
            "edges": self.edge_count,
            "bound": self._bound_keys is not None,
            "cold_subscribers": self._cold_count,
            "layout_version": self.layout_version,
            "rebuilds": self.rebuilds,
            "retired_edges": self.retired_edges,
            "published_events": self.published_events,
            "delivered_events": self.delivered_events,
            "pull_deliveries": self.pull_deliveries,
            "push_deliveries": self.push_deliveries,
            "dropped_lanes": self.dropped_lanes,
            "redeliveries": self.redeliveries,
        }
