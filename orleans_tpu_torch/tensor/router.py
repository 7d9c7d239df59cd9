"""VectorRouter: the cross-silo batched vector data plane (the port of
``orleans_tpu/tensor/router.py``, less the rebalancer's live migration
``migrate_keys_out`` / ``drain_migrate_out``, which come with its slice).

The reference crosses the silo boundary one message at a time through a
dedicated sender thread that batch-serializes whatever is queued
(reference: src/OrleansRuntime/Messaging/OutgoingMessageSender.cs:128-176);
here batches stay batches across the boundary.  When a vector batch's keys
hash to a remote silo's arena, the router partitions the batch by ring
owner, ships each partition as ONE (keys, args) slab through the codec,
and the peer injects it into its engine as a batch.

Single-activation enforcement (reference: Catalog.cs:533-563;
LocalGrainDirectory.cs:510): a vector grain's arena row may exist ONLY on
its ring owner.  Every entry point — host batches, the per-message
dispatcher bridge, optimistic device-miss activation — derives ownership
from the same vectorized ring hash (hashing.ring_hash_int_keys ==
GrainId.ring_hash bit for bit).  On a ring change, rows whose keys are no
longer owned are pushed to their new owner (``adopt_grains``) and written
back, then evicted (reference: GrainDirectoryHandoffManager.cs:141); a
handoff fence defers first-touch activation until every peer has
released the new view.

A ``ClusterInjector`` with a device-resident payload gathers the local
slice and every remote destination's slice in one launch of K22
(``kernels/router.py``): the local slice stays on the card, the remote
slices cross to the host with one copy.  Everything the router keeps past
a call is a copy or host numpy: a caller may rewrite its tensor in place
after the call, where a JAX array cannot change.

Fan-out contract: DeviceFanout subscription graphs are owner-local state;
a slab ships pre-expansion messages and the owner expands them.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from orleans_tpu_torch.hashing import ring_hash_int_keys
from orleans_tpu_torch.ids import (
    GrainCategory,
    GrainId,
    SiloAddress,
    SystemTargetCodes,
)
from orleans_tpu_torch.kernels.router import (
    fetch_segments,
    gather_tree,
    is_scalar_leaf,
    tree_leaves,
    tree_replace,
)
from orleans_tpu_torch.runtime.messaging import (
    SLAB_METHOD,
    Category,
    Direction,
    Message,
)
from orleans_tpu_torch.tensor.engine import (
    BatchInjector,
    _map_tree,
    _map_trees,
    _park_copy,
)
from orleans_tpu_torch.tensor.vector_grain import vector_type


def _host_leaf(a: Any) -> np.ndarray:
    """A payload leaf as host numpy that the caller cannot change: a
    tensor is copied off its device (a CPU tensor's memory is copied
    too); host arrays stay as they are, as in the JAX package."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return t.cpu().numpy() if t.device.type != "cpu" \
            else t.numpy().copy()
    return np.asarray(a)


def _gather_args(args: Any, idx: np.ndarray) -> Any:
    """Take rows ``idx`` of every array leaf (scalar leaves broadcast)."""
    def take(a):
        if is_scalar_leaf(a):
            return a
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return np.asarray(a)[idx]

    return _map_tree(take, args)


def _host_args(args: Any) -> Any:
    return _map_tree(_host_leaf, args)


def _merge_fragments(frags: List[Tuple[np.ndarray, Any]]
                     ) -> Tuple[np.ndarray, Any]:
    """Concatenate per-destination slab fragments into one (keys, args)
    slab; scalar leaves broadcast to their fragment's row count first
    (same discipline as engine._coalesce_host_batches)."""
    keys = np.concatenate([k for k, _ in frags])

    def cat(*leaves):
        return np.concatenate(
            [np.broadcast_to(np.asarray(x),
                             (len(frags[i][0]),) + np.shape(x)[1:])
             if np.ndim(x) == 0 else np.asarray(x)
             for i, x in enumerate(leaves)])

    args = _map_trees(cat, *(a for _, a in frags))
    return keys, args


def _send_release(silo, target: SiloAddress, digest: Tuple[str, ...]) -> None:
    """One-way handoff_release to a peer's vector_router target."""
    silo.message_center.send_message(Message(
        category=Category.SYSTEM,
        direction=Direction.ONE_WAY,
        sending_silo=silo.address,
        sending_grain=silo.client_grain_id,
        target_silo=target,
        target_grain=GrainId.system_target(
            int(SystemTargetCodes.VECTOR_ROUTER)),
        method_name="handoff_release",
        args=(list(digest), silo.address),
    ))


class VectorRouter:
    """One per clustered silo; registered as the ``vector_router`` system
    target so peers can address slabs to it."""

    def __init__(self, silo) -> None:
        self.silo = silo
        self.engine = silo.tensor_engine
        self.engine.router = self
        # owner tables cache, keyed by (ring.version, type_code) — the ring
        # invalidates by version bump on membership change
        self._my_index_cache: Tuple[int, int] = (-2, -2)
        self.slabs_shipped = 0
        self.messages_shipped = 0
        self.slabs_received = 0
        self.messages_received = 0
        self.slabs_requeued = 0
        self.messages_dropped = 0
        self.slab_retry_limit = 8
        self._retry_tasks: Set[asyncio.Task] = set()
        # -- sender-side slab aggregation ---------------------------------
        # fragments produced within one drain cycle (one synchronous burst
        # of the event loop) accumulate per (target, type, method) and
        # flush as ONE merged slab, so the receiver sees a handful of
        # stable-bucketed batch sizes instead of N compile-churning ones
        # (the sender-side analog of engine._coalesce_host_batches; the
        # reference batch-drains its per-destination send queues in
        # SocketSender/SiloMessageSender rather than writing singly).
        # Toggle (config.tensor.slab_aggregation) kept for A/B measurement
        # — bench.py --workload cluster publishes both sides.
        self.aggregate_slabs = bool(getattr(
            silo.config.tensor, "slab_aggregation", True))
        self._pending_slabs: Dict[Tuple, List[Tuple[np.ndarray, Any]]] = {}
        self._flush_scheduled = False
        self.slab_fragments = 0   # ship_slab calls (pre-merge)
        self.slab_frames = 0      # one-way frames actually sent (post-merge)
        self.slab_bounces = 0     # frames the transport bounced back to us
        # recurring-slab injector cache (see _inject_local)
        self._slab_injectors: Dict[Tuple, Any] = {}
        self._slab_key_counts: Dict[Tuple, int] = {}
        # -- placement overrides (live migration across silos) -------------
        # type_name → {key: SiloAddress}: keys the rebalance plane moved
        # OFF their ring-hash owner.  partition() applies them after the
        # hash, so every entry point (host batches, miss activation,
        # slab arrivals) gets the same one answer — the directory's
        # "exception table" for migrated vector grains.  Scoped to the
        # current membership VIEW: any ring change clears them (keys
        # re-home by hash; the handoff migration moves state to match).
        self._placement: Dict[str, Dict[int, SiloAddress]] = {}
        self._placement_arrays_cache: Dict[str, Tuple] = {}
        self.grains_migrated_out = 0
        self.grains_adopted = 0
        self.adopt_conflicts = 0
        # -- handoff fence (ordering for ownership moves) ------------------
        # A ring change moves key ranges between silos, but old and new
        # owners process the change at independent times: the new owner's
        # first-touch store READ could precede the old owner's write-back,
        # silently losing state (the race the reference's
        # GrainDirectoryHandoffManager transfer protocol closes).  Fence:
        # after processing a change (write-back + evict done), each silo
        # broadcasts handoff_release(view-digest) to its peers; a silo
        # defers ACTIVATION of unseen keys until every alive peer has
        # released the current view (or the fence times out — a dead/
        # stalled peer must not wedge the cluster; its loss window is the
        # documented checkpoint cadence).
        self._fence_version = -1
        self._barrier_digest: Tuple[str, ...] = ()
        self._awaiting: Set[SiloAddress] = set()
        self._acks: Dict[SiloAddress, Tuple[str, ...]] = {}
        self._handoff_deadline = 0.0
        self.handoff_timeout = getattr(silo.config.tensor,
                                       "handoff_fence_timeout", 2.0)
        # arm/broadcast on EVERY ring change, even before the silo is
        # ACTIVE (a joining silo must release its peers — it holds no
        # rows, so its release is trivially true; eviction for active
        # silos already ran: the silo's own ring subscription precedes
        # this one, so on_ring_changed's write-back happens first).
        # A SHUTTING_DOWN silo's release is also sound: its ranges move
        # only at membership leave, and graceful stop checkpoints the
        # arenas BEFORE the leave (silo.py stop ordering), so any range
        # a peer gains from it is already durable; mid-shutdown ring
        # changes caused by THIRD silos move no ranges away from it.
        silo.ring.subscribe(lambda *_: self._arm_fence())

    # ================= ownership ==========================================

    def _my_index(self, members: List[SiloAddress]) -> int:
        version = self.silo.ring.version
        cached_version, idx = self._my_index_cache
        if cached_version != version:
            try:
                idx = members.index(self.silo.address)
            except ValueError:
                idx = -1  # non-hosting observer: owns nothing
            self._my_index_cache = (version, idx)
        return idx

    def partition(self, type_name: str, keys: np.ndarray
                  ) -> Tuple[np.ndarray, Dict[SiloAddress, np.ndarray]]:
        """Split ``keys`` (int64[n]) by ring owner.

        Returns ``(local_mask bool[n], {owner: index_array})`` where the
        index arrays cover exactly the non-local entries.  Single-member
        rings short-circuit to all-local (zero hashing cost)."""
        ring = self.silo.ring
        keys = np.asarray(keys, dtype=np.int64)
        ov = self._placement.get(type_name)
        if len(ring._members) <= 1 and self._my_index(ring.members) == 0 \
                and not ov:
            return np.ones(len(keys), dtype=bool), {}
        info = vector_type(type_name)
        points = ring_hash_int_keys(info.type_code, keys,
                                    category=int(GrainCategory.GRAIN))
        owner_idx, members = ring.owners_of_hashes(points)
        my = self._my_index(members)
        if ov:
            # live-migration overrides beat the hash (the directory's
            # exception table): one vectorized membership test over the
            # pinned set, then one vectorized rewrite of the hits (the JAX
            # router rewrites hit by hit in Python, which costs about a
            # microsecond a lane once a handoff's adoption has pinned
            # every adopted key)
            pk, codes, targets = self._placement_arrays(type_name)
            idx = np.minimum(np.searchsorted(pk, keys), len(pk) - 1)
            hits = np.nonzero(pk[idx] == keys)[0]
            if len(hits):
                members = list(members)
                midx = {m: i for i, m in enumerate(members)}
                for t in targets:
                    if t not in midx:
                        members.append(t)
                        midx[t] = len(members) - 1
                to_member = np.asarray([midx[t] for t in targets],
                                       dtype=owner_idx.dtype)
                owner_idx = owner_idx.copy()
                owner_idx[hits] = to_member[codes[idx[hits]]]
                my = midx.get(self.silo.address, -1)
        local_mask = owner_idx == my
        remote: Dict[SiloAddress, np.ndarray] = {}
        if not local_mask.all():
            for o in np.unique(owner_idx[~local_mask]):
                if o < 0:
                    continue
                remote[members[int(o)]] = np.nonzero(owner_idx == o)[0]
        return local_mask, remote

    def _placement_arrays(self, type_name: str) -> Tuple:
        """Sorted mirror of one type's placement overrides: (keys
        int64[], target codes int32[] into ``targets``, the distinct
        targets), cached until the override set mutates."""
        cached = self._placement_arrays_cache.get(type_name)
        ov = self._placement.get(type_name, {})
        if cached is not None and cached[3] == len(ov):
            return cached[:3]
        pk = np.fromiter(ov.keys(), dtype=np.int64, count=len(ov))
        order = np.argsort(pk)
        targets: List[SiloAddress] = []
        code_of: Dict[SiloAddress, int] = {}
        codes = np.empty(len(ov), dtype=np.int32)
        for i, t in enumerate(ov.values()):
            c = code_of.get(t)
            if c is None:
                c = code_of[t] = len(targets)
                targets.append(t)
            codes[i] = c
        cached = (pk[order], codes[order], targets, len(ov))
        self._placement_arrays_cache[type_name] = cached
        return cached[:3]

    def register_placement(self, type_name: str, keys: np.ndarray,
                           target: SiloAddress) -> None:
        """Record live-migration placement overrides (idempotent; the
        broadcast applies them on every silo so ownership has one
        answer everywhere)."""
        ov = self._placement.setdefault(type_name, {})
        for k in np.asarray(keys, dtype=np.int64).tolist():
            ov[int(k)] = target
        self._placement_arrays_cache.pop(type_name, None)

    def owns_key(self, type_name: str, key: int) -> bool:
        local, _ = self.partition(type_name,
                                  np.asarray([key], dtype=np.int64))
        return bool(local[0])

    # ================= handoff fence ======================================

    def _view_digest(self) -> Tuple[str, ...]:
        return tuple(sorted(str(m) for m in self.silo.ring.members))

    def _arm_fence(self) -> None:
        """Ring changed: broadcast our release (write-back for this change
        is already durable — the silo's eviction subscription runs before
        this one) and start awaiting the peers' releases."""
        ring = self.silo.ring
        self._fence_version = ring.version
        digest = self._view_digest()
        self._barrier_digest = digest
        peers = [m for m in ring.members if m != self.silo.address]
        self._awaiting = {p for p in peers if self._acks.get(p) != digest}
        self._handoff_deadline = time.monotonic() + self.handoff_timeout
        for p in peers:
            _send_release(self.silo, p, digest)

    async def handoff_release(self, digest, sender: SiloAddress) -> None:
        """Peer finished its write-back for the membership view ``digest``
        — unseen keys in ranges we gained from it are now safe to
        activate from the store."""
        digest = tuple(digest)
        self._acks[sender] = digest
        if digest == self._barrier_digest:
            self._awaiting.discard(sender)

    def handoff_settled(self) -> bool:
        """True when first-touch activation is safe: every alive peer has
        released the current membership view (their write-back for any
        range we gained is durable).  The engine defers unseen-key
        activation while this is False; traffic to already-active rows is
        unaffected."""
        if self._fence_version != self.silo.ring.version:
            self._arm_fence()
        if not self._awaiting:
            return True
        if time.monotonic() >= self._handoff_deadline:
            self.silo.logger.warn(
                f"handoff fence timed out awaiting release from "
                f"{[str(p) for p in self._awaiting]} — proceeding "
                f"(their write-back may still be in flight)", code=2912)
            self._awaiting.clear()
            return True
        alive = set(self.silo.active_silos())
        self._awaiting = {p for p in self._awaiting if p in alive}
        return not self._awaiting

    # ================= send side ==========================================

    def route_batch(self, type_name: str, method: str, keys: np.ndarray,
                    args: Any, want_results: bool = False
                    ) -> Optional[asyncio.Future]:
        """Cluster-level send_batch: local partition enqueues on this
        silo's engine, each remote partition ships as one slab."""
        keys = np.asarray(keys, dtype=np.int64)
        local_mask, remote = self.partition(type_name, keys)
        if not remote:
            return self.engine.enqueue_local_batch(
                type_name, method, keys, args, want_results=want_results)
        args_h = _host_args(args)
        if not want_results:
            if local_mask.any():
                lidx = np.nonzero(local_mask)[0]
                self.engine.enqueue_local_batch(
                    type_name, method, keys[lidx], _gather_args(args_h, lidx))
            for target, idx in remote.items():
                self.ship_slab(target, type_name, method, keys[idx],
                               _gather_args(args_h, idx))
            return None
        return asyncio.get_running_loop().create_task(
            self._route_with_results(type_name, method, keys, args_h,
                                     local_mask, remote))

    async def _route_with_results(self, type_name: str, method: str,
                                  keys: np.ndarray, args_h: Any,
                                  local_mask: np.ndarray,
                                  remote: Dict[SiloAddress, np.ndarray],
                                  hops: int = 0) -> Any:
        """Scatter a want_results batch, await all partitions, reassemble
        the result pytree in the caller's original message order."""
        if remote and hops > self.silo.max_forward_count:
            # diverged ring views could bounce a slab between silos
            # forever — bound the hop chain like any forwarded request
            # (reference: Dispatcher.TryForwardRequest :474)
            raise RuntimeError(
                f"vector slab for {type_name} exceeded max forward count "
                f"({hops} hops; ring views diverged?)")
        parts: List[Tuple[np.ndarray, Any]] = []  # (index array, awaitable)
        if local_mask.any():
            lidx = np.nonzero(local_mask)[0]
            fut = self.engine.enqueue_local_batch(
                type_name, method, keys[lidx], _gather_args(args_h, lidx),
                want_results=True)
            parts.append((lidx, fut))
        for target, idx in remote.items():
            self.messages_shipped += len(idx)
            self.slabs_shipped += 1
            coro = self.silo.system_rpc(
                target, "vector_router", "call_slab",
                (type_name, method, keys[idx], _gather_args(args_h, idx),
                 hops + 1))
            parts.append((idx, coro))
        results = await asyncio.gather(*(p[1] for p in parts))
        if all(r is None for r in results):
            return None
        n = len(keys)

        def scatter(*leaves):
            out = None
            for (idx, _), leaf in zip(parts, leaves):
                if leaf is None:
                    continue
                leaf = np.asarray(leaf)
                if out is None:
                    out = np.zeros((n,) + leaf.shape[1:], dtype=leaf.dtype)
                out[idx] = leaf
            return out

        # all non-None parts share one handler → one tree structure
        first = next(r for r in results if r is not None)
        n_leaves = len(tree_leaves(first))
        leaves_per_part = [tree_leaves(r) if r is not None
                           else [None] * n_leaves for r in results]
        combined = [scatter(*[lp[i] for lp in leaves_per_part])
                    for i in range(n_leaves)]
        return tree_replace(first, combined)

    def ship_slab(self, target: SiloAddress, type_name: str, method: str,
                  keys: np.ndarray, args: Any, hops: int = 0,
                  retries: int = 0) -> None:
        """One (keys, args) slab fragment bound for ``target``'s router
        (the batched silo boundary; never per-message send_one).

        With aggregation on (default), fragments accumulate per
        (target, type, method, hops, retries) and flush as ONE merged
        frame at the end of the current drain cycle; with it off every
        fragment is its own frame.  ``retries`` rides the wire so the
        backoff budget accumulates across silos — a slab ping-ponging
        between diverged ring views still hits the drop limit instead of
        circulating forever."""
        keys = np.asarray(keys, dtype=np.int64)
        self.slab_fragments += 1
        self.messages_shipped += len(keys)
        if not self.aggregate_slabs:
            self._ship_frame(target, type_name, method, keys,
                             _host_args(args), hops, retries)
            return
        bucket = (target, type_name, method, int(hops), int(retries))
        self._pending_slabs.setdefault(bucket, []).append(
            (keys, _host_args(args)))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self.flush_slabs)

    def flush_slabs(self) -> None:
        """End-of-drain-cycle flush: one merged frame per pending
        (destination, type, method) bucket."""
        self._flush_scheduled = False
        pending, self._pending_slabs = self._pending_slabs, {}
        for (target, type_name, method, hops, retries), frags \
                in pending.items():
            if len(frags) == 1:
                keys, args = frags[0]
            else:
                try:
                    keys, args = _merge_fragments(frags)
                except Exception:  # noqa: BLE001 — mismatched arg trees
                    # cannot merge (should not happen within one (type,
                    # method)); ship unmerged rather than lose payload
                    for keys, args in frags:
                        self._ship_frame(target, type_name, method, keys,
                                         args, hops, retries)
                    continue
            self._ship_frame(target, type_name, method, keys, args,
                             hops, retries)

    def _ship_frame(self, target: SiloAddress, type_name: str, method: str,
                    keys: np.ndarray, args: Any, hops: int,
                    retries: int) -> None:
        self.slabs_shipped += 1
        self.slab_frames += 1
        msg = Message(
            category=Category.APPLICATION,
            direction=Direction.ONE_WAY,
            sending_silo=self.silo.address,
            sending_grain=self.silo.client_grain_id,
            target_silo=target,
            target_grain=GrainId.system_target(
                int(SystemTargetCodes.VECTOR_ROUTER)),
            method_name=SLAB_METHOD,
            args=(type_name, method, keys, args, hops, retries),
        )
        self.silo.message_center.send_message(msg)

    def reinject_bounced(self, msg, reason: str) -> None:
        """The transport bounced a slab frame back (link down, byte/count
        queue overflow): park the payload and retry with backoff instead
        of dropping it — a transient link failure redelivers; only the
        retry budget's exhaustion loses messages (and that is logged)."""
        type_name, method, keys, args = msg.args[:4]
        retries = int(msg.args[5]) if len(msg.args) > 5 else 0
        self.slab_bounces += 1
        self.silo.logger.warn(
            f"slab frame for {type_name} to {msg.target_silo} bounced "
            f"({reason}) — re-injecting with backoff", code=2914)
        self._backoff_reinject(type_name, method,
                               np.asarray(keys, dtype=np.int64), args,
                               retries)

    def make_injector(self, type_name: str, method: str, keys: np.ndarray):
        """Cluster-aware steady-state injector: resolves the ownership
        split once per ring version; every inject() is one local enqueue
        + one slab per remote owner."""
        return ClusterInjector(self, type_name, method,
                               np.asarray(keys, dtype=np.int64))

    # ================= receive side (system target) =======================

    async def inject_slab(self, type_name: str, method: str,
                          keys: np.ndarray, args: Any, hops: int = 0,
                          retries: int = 0, _recount: bool = True) -> None:
        """Peer slab arrival: verify ownership (the ring may have moved
        while the slab was in flight) and enqueue the owned part; forward
        strays with a bounded hop count (reference: MaxForwardCount,
        Dispatcher.TryForwardRequest :474).  A slab that exhausts its hop
        budget is NOT dropped: diverged ring views converge within a
        membership refresh, so the holder parks it and re-injects with
        backoff (the batched analog of the reference's resend-with-
        backoff; only the retry budget's exhaustion loses messages, and
        that is logged as an error)."""
        keys = np.asarray(keys, dtype=np.int64)
        if _recount:  # local backoff re-entries must not double-count
            self.slabs_received += 1
            self.messages_received += len(keys)
        local_mask, remote = self.partition(type_name, keys)
        if local_mask.any():
            idx = np.nonzero(local_mask)[0]
            self._inject_local(type_name, method, keys[idx],
                               _gather_args(args, idx))
            self.engine._wake_up()
        for target, idx in remote.items():
            if hops + 1 > self.silo.max_forward_count:
                self._backoff_reinject(type_name, method, keys[idx],
                                       _gather_args(args, idx), retries)
                continue
            self.ship_slab(target, type_name, method, keys[idx],
                           _gather_args(args, idx), hops=hops + 1,
                           retries=retries)

    def _inject_local(self, type_name: str, method: str,
                      keys: np.ndarray, args: Any) -> None:
        """Enqueue a slab's locally-owned partition.

        Steady cross-silo traffic repeats the same key set every slab
        (the sender's ClusterInjector split is cached), but each arrival
        deserializes to FRESH arrays — so the receiving engine would
        re-resolve rows per slab and its auto-fuser would never see a
        stable pattern (its signature keys on the key array's identity).
        Cache a BatchInjector per recurring (type, method, keys) slab
        shape: repeats ride the cached-row fast path AND present a
        stable identity, so the RECEIVING silo's steady state fuses just
        like the sender's (north star: batches stay batches across the
        boundary, including the compiled tier)."""
        digest = (type_name, method, len(keys),
                  hash(keys.tobytes()))
        cached = self._slab_injectors.get(digest)
        if cached is not None and np.array_equal(cached.keys, keys):
            # LRU touch: insertion order doubles as recency order
            self._slab_injectors[digest] = self._slab_injectors.pop(digest)
            cached.inject(args)
            return
        count = self._slab_key_counts.get(digest, 0) + 1
        if digest not in self._slab_key_counts \
                and len(self._slab_key_counts) >= 1024:
            # churny, never-recurring shapes must not grow this without
            # bound; recurring shapes re-accumulate in 3 arrivals
            self._slab_key_counts.clear()
        self._slab_key_counts[digest] = count
        if count >= 3:  # recurring slab shape: build the cached edge
            inj = BatchInjector(self.engine, type_name, method, keys)
            self._slab_injectors[digest] = inj
            self._slab_key_counts.pop(digest, None)
            while len(self._slab_injectors) > 64:
                # least-recently-used falls off; hot shapes were touched
                # to the end above, so they survive
                self._slab_injectors.pop(next(iter(self._slab_injectors)))
            inj.inject(args)
            return
        self.engine.enqueue_local_batch(type_name, method, keys, args)

    def _backoff_reinject(self, type_name: str, method: str,
                          keys: np.ndarray, args: Any, retries: int) -> None:
        """Over-forwarded slab: park it and retry with a fresh hop budget
        once ring views have had time to converge."""
        if retries >= self.slab_retry_limit:
            self.messages_dropped += len(keys)
            self.silo.logger.error(
                f"dropping {len(keys)}-message slab for {type_name} after "
                f"{retries} backoff retries: ring views never converged",
                code=2910)
            return
        self.slabs_requeued += 1
        delay = min(0.05 * (2 ** retries), 1.0)

        async def retry() -> None:
            await asyncio.sleep(delay)
            from orleans_tpu_torch.runtime.silo import SiloStatus
            if self.silo.status == SiloStatus.DEAD:
                return
            await self.inject_slab(type_name, method, keys, args,
                                   hops=0, retries=retries + 1,
                                   _recount=False)

        # hold a strong reference: asyncio keeps only weak refs to tasks,
        # and this task is the sole holder of the parked slab's data
        task = asyncio.get_running_loop().create_task(retry())
        self._retry_tasks.add(task)
        task.add_done_callback(self._retry_tasks.discard)

    async def call_slab(self, type_name: str, method: str,
                        keys: np.ndarray, args: Any, hops: int = 1) -> Any:
        """Request/response slab (want_results path).  Re-partitions on
        arrival (ring may have moved) with the hop chain bounded — never
        an unbounded bounce between silos with diverged views."""
        self.slabs_received += 1
        self.messages_received += len(keys)
        keys = np.asarray(keys, dtype=np.int64)
        local_mask, remote = self.partition(type_name, keys)
        self.engine._wake_up()
        return await self._route_with_results(
            type_name, method, keys, _host_args(args), local_mask, remote,
            hops=hops)

    # ================= live migration (cross-silo) ========================

    def _ship_adopt(self, target: SiloAddress, type_name: str,
                    keys: np.ndarray,
                    columns: Dict[str, np.ndarray],
                    timers=None) -> None:
        """One-way adopt_grains frame: a migrated partition's state slab
        (key column + every state column, the same columnar shape the
        checkpoint drain writes) plus any armed device timers detached
        from the movers (transport-plain payload, relative remaining
        ticks).  Sent on the same link as (and therefore FIFO-before)
        any later handoff release, so a peer's first-touch miss after
        the release finds the keys already adopted."""
        self.silo.message_center.send_message(Message(
            category=Category.SYSTEM,
            direction=Direction.ONE_WAY,
            sending_silo=self.silo.address,
            sending_grain=self.silo.client_grain_id,
            target_silo=target,
            target_grain=GrainId.system_target(
                int(SystemTargetCodes.VECTOR_ROUTER)),
            method_name="adopt_grains",
            args=(type_name, np.asarray(keys, dtype=np.int64),
                  {n: np.asarray(c) for n, c in columns.items()},
                  self.silo.address, timers),
        ))

    async def adopt_grains(self, type_name: str, keys, columns,
                           sender: SiloAddress, timers=None) -> int:
        """Receive a live-migrated partition: register the placement
        override (this silo now OWNS these keys — the one-answer
        contract) and land the pushed state at freshly allocated rows.
        First-writer-wins on keys already live here (the
        register_single discipline; counted as adopt_conflicts).  The
        store is bypassed — a migration is a MOVE, not a re-activation:
        reading persisted rows underneath the pushed state would
        resurrect the old owner's last write-back over its final
        state."""
        keys = np.asarray(keys, dtype=np.int64)
        eng = self.engine
        arena = eng.arena_for(type_name)
        self.register_placement(type_name, keys, self.silo.address)
        _rows, found = arena.lookup_rows(keys)
        conflicts = int(found.sum())
        fresh = ~found
        n = int(fresh.sum())
        if n:
            fidx = np.nonzero(fresh)[0]
            store = arena.store
            arena.store = None
            try:
                arena._activate_keys(keys[fidx])
            finally:
                arena.store = store
            rows, ok = arena.lookup_rows(keys[fidx])
            assert ok.all()
            arena.scatter_restore(
                rows.astype(np.int64),
                {name: np.asarray(col)[fidx]
                 for name, col in columns.items()},
                np.zeros(n, dtype=np.int32))
            # adopted rows stamp THIS engine's clock: the sender's tick
            # counter is meaningless here, and "just migrated" is
            # exactly "just touched" for the idle collector
            arena.last_use_tick[rows] = eng.tick_number
            eng.migrations += 1
            eng.grains_migrated += n
        if timers:
            # armed timers move WITH their grain (Orleans: a reminder
            # survives migration): re-armed at the local clock, recorded
            # as arm ops for this silo's next checkpoint cut
            eng.timers.adopt_keys(type_name, timers)
        self.grains_adopted += n
        self.adopt_conflicts += conflicts
        eng._wake_up()
        # coverage report: the sender declares the move successful only
        # when adopted + already-live accounts for EVERY key (a
        # tensor-less stub's 0/0 must read as failure, never success)
        return {"adopted": n, "live": conflicts}

    async def place_keys(self, type_name: str, keys,
                         target: SiloAddress) -> bool:
        """Peer notification of a live migration: route these keys to
        ``target`` from now on (until the next ring change re-homes
        them by hash)."""
        self.register_placement(type_name, np.asarray(keys, np.int64),
                                target)
        return True

    # ================= handoff (ring change) ==============================

    def on_ring_changed(self) -> None:
        """Arena half of directory handoff (reference:
        GrainDirectoryHandoffManager.cs:141): rows whose keys this silo
        no longer owns MIGRATE to their new owner — one columnar gather
        + one adopt_grains slab per destination, sent BEFORE this
        silo's fence release on the same links (FIFO: the new owner
        adopts before its first-touch misses unfence) — then evict.
        With a store attached the write-back still runs as the durable
        net under the push (equal state either way; a lost one-way
        adopt frame degrades to the old evict-and-miss path, never to
        loss).  ``rebalance.handoff_migration=False`` restores the pure
        evict-and-miss handoff (the A/B baseline)."""
        # placement overrides are scoped to the membership view: keys
        # re-home by hash and the push below moves state to match
        if self._placement:
            self._placement.clear()
            self._placement_arrays_cache.clear()
        migrate = getattr(self.silo.config, "rebalance", None)
        migrate = migrate is not None and migrate.handoff_migration
        for type_name, arena in self.engine.arenas.items():
            keys = arena.keys()
            if len(keys) == 0:
                continue
            local_mask, remote = self.partition(type_name, keys)
            stray = keys[~local_mask]
            if not len(stray):
                continue
            if migrate:
                for target, ridx in remote.items():
                    rows, found = arena.lookup_rows(keys[ridx])
                    assert found.all()
                    self._ship_adopt(target, type_name, keys[ridx],
                                     arena.rows_to_host(
                                         rows.astype(np.int64)),
                                     timers=self.engine.timers
                                     .export_keys(type_name, keys[ridx]))
                self.engine.migrations += 1
                self.engine.grains_migrated += len(stray)
                self.grains_migrated_out += len(stray)
            evicted = arena.evict_keys(stray)
            if arena.store is None and not migrate:
                # eviction preserves single-activation either way, but
                # without a store or a push the rows' state cannot
                # follow them — same contract as the reference's
                # storage-less grains (deactivation discards state),
                # surfaced loudly
                self.silo.logger.warn(
                    f"handoff: evicted {evicted} {type_name} rows "
                    "WITHOUT write-back (no VectorStore attached) — "
                    "their state restarts from field defaults on the "
                    "new owner", code=2911)
            else:
                self.silo.logger.info(
                    f"handoff: {'migrated' if migrate else 'evicted'} "
                    f"{evicted} {type_name} rows no longer owned here")

    def snapshot(self) -> Dict[str, Any]:
        return {
            "slabs_shipped": self.slabs_shipped,
            "messages_shipped": self.messages_shipped,
            "slabs_received": self.slabs_received,
            "messages_received": self.messages_received,
            "slabs_requeued": self.slabs_requeued,
            "messages_dropped": self.messages_dropped,
            "slab_fragments": self.slab_fragments,
            "slab_frames": self.slab_frames,
            "slab_bounces": self.slab_bounces,
            # live migration across silos (placement overrides +
            # adopt_grains state slabs)
            "grains_migrated_out": self.grains_migrated_out,
            "grains_adopted": self.grains_adopted,
            "adopt_conflicts": self.adopt_conflicts,
            # > 1 means sender aggregation is doing its job (fragments
            # merged per destination per drain cycle) — THE health
            # indicator for the cross-silo data plane
            "slab_merge_ratio": round(
                self.slab_fragments / self.slab_frames, 3)
            if self.slab_frames else 0.0,
        }


class HandoffFenceStub:
    """The 'vector_router' system target for a clustered silo WITHOUT a
    tensor engine: it owns no vector rows, so its write-back for any ring
    change is trivially complete — but peers' handoff fences still await
    its release.  The stub broadcasts releases so mixed clusters (tensor
    + non-tensor silos) settle in one RTT instead of stalling every ring
    change to the fence timeout."""

    def __init__(self, silo) -> None:
        self.silo = silo
        silo.ring.subscribe(lambda *_: self._broadcast())

    def _view_digest(self):
        return tuple(sorted(str(m) for m in self.silo.ring.members))

    def _broadcast(self) -> None:
        digest = self._view_digest()
        for p in self.silo.ring.members:
            if p != self.silo.address:
                _send_release(self.silo, p, digest)

    async def handoff_release(self, digest, sender) -> None:
        pass  # no fence here: nothing ever defers activation

    async def inject_slab(self, type_name: str, method: str,
                          keys, args, hops: int = 0, retries: int = 0,
                          _recount: bool = True) -> None:
        self.silo.logger.error(
            f"dropping {len(keys)}-message slab for {type_name}: this "
            f"silo has no tensor engine (ring misconfiguration — "
            f"non-tensor silos should not own vector key ranges)",
            code=2913)

    async def adopt_grains(self, type_name: str, keys, columns,
                           sender, timers=None):
        self.silo.logger.error(
            f"dropping {len(keys)}-grain migration slab for "
            f"{type_name}: this silo has no tensor engine (ring "
            f"misconfiguration — non-tensor silos should not own "
            f"vector key ranges)", code=2913)
        return {"adopted": 0, "live": 0}

    async def place_keys(self, type_name: str, keys, target) -> bool:
        return True  # nothing routes from here; nothing to override


class ClusterInjector:
    """Steady-state cluster injector: the ownership split of a stable key
    set is computed once per ring version; each ``inject`` is one local
    enqueue plus one pre-gathered slab per remote owner (the cross-silo
    analog of BatchInjector's cached-row fast path).  A membership change
    invalidates the split — injecting through a stale split would
    re-activate keys the handoff just evicted.

    The split is one permutation of the key set's lanes — the local
    lanes, then each destination's — so a device payload is gathered in
    one K22 launch into one packed buffer: the local segment's leaves go
    to the local ``BatchInjector`` as views, the remote segments cross to
    the host with one copy and ship as numpy slabs."""

    def __init__(self, router: VectorRouter, type_name: str, method: str,
                 keys: np.ndarray) -> None:
        self.router = router
        self.type_name = type_name
        self.method = method
        self.keys = keys
        self.n = len(keys)
        self._ring_version = -1
        # the payload staged for the next inject(): a copy, since the
        # caller may rewrite its tensors before that call
        self._staged: Optional[Any] = None
        self._rebuild()

    def _rebuild(self) -> None:
        self._ring_version = self.router.silo.ring.version
        local_mask, remote = self.router.partition(self.type_name,
                                                   self.keys)
        self._all_local = not remote
        self._local_idx = np.nonzero(local_mask)[0]
        self._remote = list(remote.items())
        # the split as one permutation and its segment bounds
        parts = [self._local_idx] + [idx for _, idx in self._remote]
        self._perm = np.concatenate(parts).astype(np.int32)
        self._bounds = np.concatenate(
            [[0], np.cumsum([len(p) for p in parts])]).tolist()
        self._perm_dev: Dict[torch.device, torch.Tensor] = {}
        self._local = None
        if len(self._local_idx):
            self._local = BatchInjector(
                self.router.engine, self.type_name, self.method,
                self.keys if self._all_local
                else self.keys[self._local_idx])

    def _perm_on(self, device: torch.device) -> torch.Tensor:
        perm = self._perm_dev.get(device)
        if perm is None:
            perm = self._perm_dev[device] = torch.from_numpy(
                self._perm).to(device)
        return perm

    def stage(self, args: Any) -> Any:
        """Keep the next injection's payload (a copy of its tensors)."""
        self._staged = _map_tree(_park_copy, args)
        return args

    def inject(self, args: Any = None, want_results: bool = False
               ) -> Optional[asyncio.Future]:
        if args is None:
            args, self._staged = self._staged, None
            if args is None:
                raise ValueError("inject() with no args needs a staged "
                                 "slab — call stage(args) first")
        else:
            self._staged = None  # an explicit injection supersedes
        if self._ring_version != self.router.silo.ring.version:
            self._rebuild()
        if self._all_local and not want_results:
            return self._local.inject(args)  # zero-copy fast path
        if want_results:
            # results need order reassembly — reuse the routed path
            return self.router.route_batch(self.type_name, self.method,
                                           self.keys, args,
                                           want_results=True)
        tensors = [a for a in tree_leaves(args)
                   if isinstance(a, torch.Tensor) and a.dim()]
        if tensors:
            # device payloads: one K22 launch gathers every segment; the
            # local slice never leaves the device, the remote slices cross
            # at their partition size with one copy
            staging, layout, leaves, trees = gather_tree(
                args, self._perm_on(tensors[0].device), self._bounds)
            if self._local is not None:
                self._local.inject(trees[0])
            if self._remote:
                host = fetch_segments(staging, layout, leaves, args)
                for (target, idx), tree in zip(self._remote, host):
                    self.router.ship_slab(target, self.type_name,
                                          self.method, self.keys[idx], tree)
            return None
        args_h = _host_args(args)
        if self._local is not None:
            self._local.inject(_gather_args(args_h, self._local_idx))
        for target, idx in self._remote:
            self.router.ship_slab(target, self.type_name, self.method,
                                  self.keys[idx], _gather_args(args_h, idx))
        return None
