"""Chat rooms and leaderboards — million-user scenarios on the device
streams plane (``tensor/streams_plane.py``), on the port.

The torch twin of ``samples/streams.py``.  Both scenarios share one
shape: a small set of STREAMS (chat rooms, leaderboards) with a large,
churning SUBSCRIBER population (users, board members).  The reference
runs them as pub-sub over grains — one rendezvous lookup and one grain
call per (event, consumer) (PubSubRendezvousGrain,
PersistentStreamPullingAgent); here the subscriber adjacency lives on
the card and a tick's publishes fan out with one gather per edge and the
subscribers' row-range reductions (K16).

Exactness oracle: every loader can replay its publish history against the
HOST adjacency (``np.add.at`` / ``np.maximum.at``: one virtual grain call
per (event, subscriber)) and compare the subscriber arena field by field.
Every checked field is an integer, so equality is exact.

The JAX loaders stage each tick's payload (``BatchInjector.stage``) and
then inject it; the port's injector has no ``stage`` yet, so these
loaders call ``inject(args)`` with the same payload.
``run_chat_stream_load`` (the persistent-streams pipeline through a silo)
waits for the port's host integration.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    seg_max,
    seg_sum,
    vector_grain,
)

#: checksum mixers (primes) — integer, so device and host agree exactly
_MSG_MIX = 1009
_SRC_MIX = 97


@vector_grain
class ChatRoomGrain(VectorGrain):
    """Stream ingress: one row per room.  ``publish`` records the room's
    side; delivery to every member rides the registered
    ``DeviceSubscriptions``."""

    published = field(torch.int32, 0)
    last_msg = field(torch.int32, -1)

    @batched_method
    @staticmethod
    def publish(state, batch: Batch, n_rows: int):
        rows, mask = batch.rows, batch.mask
        ones = mask.to(torch.int32)
        msg = torch.where(mask, batch.args["msg_id"].to(torch.int32), -1)
        return {
            **state,
            "published": state["published"] + seg_sum(ones, rows, n_rows),
            "last_msg": torch.maximum(state["last_msg"],
                                      seg_max(msg, rows, n_rows)),
        }


@vector_grain
class ChatUserGrain(VectorGrain):
    """Subscriber: one row per user.  ``receive`` takes the pull path's
    row-range reductions when the batch carries ``segments``, the scatter
    reductions for push-mode deliveries."""

    received = field(torch.int32, 0)
    last_msg = field(torch.int32, -1)
    checksum = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def receive(state, batch: Batch, n_rows: int):
        rows, args, seg, mask = batch.rows, batch.args, batch.segments, \
            batch.mask
        ones = mask.to(torch.int32)
        msg = args["msg_id"].to(torch.int32)
        src = args["src_key"].to(torch.int32)
        mix = torch.where(mask, msg % _MSG_MIX + src % _SRC_MIX, 0) \
            .to(torch.int32)
        return {
            **state,
            "received": state["received"]
            + seg_sum(ones, rows, n_rows, segments=seg),
            "last_msg": torch.maximum(
                state["last_msg"],
                seg_max(torch.where(mask, msg, -1), rows, n_rows,
                        segments=seg, fill=-1)),
            "checksum": state["checksum"]
            + seg_sum(mix, rows, n_rows, segments=seg),
        }


@vector_grain
class LeaderboardGrain(VectorGrain):
    """Stream ingress: one row per board; score posts aggregate on the
    board and broadcast to every follower."""

    rounds = field(torch.int32, 0)
    top_score = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def post(state, batch: Batch, n_rows: int):
        rows, mask = batch.rows, batch.mask
        ones = mask.to(torch.int32)
        score = torch.where(mask, batch.args["score"].to(torch.int32), 0)
        return {
            **state,
            "rounds": state["rounds"] + seg_sum(ones, rows, n_rows),
            "top_score": torch.maximum(state["top_score"],
                                       seg_max(score, rows, n_rows)),
        }


@vector_grain
class BoardMemberGrain(VectorGrain):
    """Subscriber: a user following one or more boards."""

    updates = field(torch.int32, 0)
    best_seen = field(torch.int32, 0)
    checksum = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def observe(state, batch: Batch, n_rows: int):
        rows, args, seg, mask = batch.rows, batch.args, batch.segments, \
            batch.mask
        ones = mask.to(torch.int32)
        score = args["score"].to(torch.int32)
        mix = torch.where(mask, score % _MSG_MIX
                          + args["src_key"].to(torch.int32) % _SRC_MIX, 0) \
            .to(torch.int32)
        return {
            **state,
            "updates": state["updates"]
            + seg_sum(ones, rows, n_rows, segments=seg),
            "best_seen": torch.maximum(
                state["best_seen"],
                seg_max(torch.where(mask, score, 0), rows, n_rows,
                        segments=seg, fill=0)),
            "checksum": state["checksum"]
            + seg_sum(mix, rows, n_rows, segments=seg),
        }


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------

def build_membership(n_streams: int, n_subscribers: int,
                     mean_memberships: float = 3.0, zipf_a: float = 1.2,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(stream_keys, sub_keys) edge arrays: room or board popularity ~
    Zipf (a few huge rooms, a long tail), every subscriber in at least one
    stream.  The same numpy draws as the JAX sample."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_subscribers * mean_memberships)
    ranks = rng.permutation(n_streams) + 1
    weights = ranks.astype(np.float64) ** (-zipf_a)
    weights /= weights.sum()
    streams = rng.choice(n_streams, size=n_edges, p=weights)
    subs = np.concatenate([
        np.arange(n_subscribers),                       # coverage
        rng.integers(0, n_subscribers, n_edges - n_subscribers),
    ]) if n_edges >= n_subscribers else rng.integers(
        0, n_subscribers, n_edges)
    return streams.astype(np.int64), subs.astype(np.int64)


class _HostMirror:
    """The oracle's expected subscriber state, advanced per publish by the
    HOST pub-sub semantics (one virtual delivery per (event, subscriber));
    re-derives its expansion whenever the adjacency changes."""

    def __init__(self, subs: DeviceSubscriptions, n_users: int) -> None:
        self.subs = subs
        self.received = np.zeros(n_users, np.int64)
        self.last_msg = np.full(n_users, -1, np.int64)
        self.checksum = np.zeros(n_users, np.int64)
        self._streams: Optional[np.ndarray] = None
        self._dsts: Optional[np.ndarray] = None
        self._srcs: Optional[np.ndarray] = None
        self._version = -1

    def _expansion(self, stream_keys: np.ndarray):
        if self._version != self.subs.layout_version \
                or self._streams is None \
                or not np.array_equal(self._streams, stream_keys):
            dsts, srcs = self.subs.host_expand(stream_keys)
            self._streams = stream_keys.copy()
            self._dsts, self._srcs = dsts, srcs
            self._version = self.subs.layout_version
        return self._dsts, self._srcs

    def publish(self, stream_keys: np.ndarray, msg_or_score: np.ndarray,
                kind: str = "chat") -> None:
        dsts, srcs = self._expansion(stream_keys)
        v = msg_or_score[srcs].astype(np.int64)
        sk = stream_keys[srcs].astype(np.int64)
        np.add.at(self.received, dsts, 1)
        if kind == "chat":
            np.maximum.at(self.last_msg, dsts, v)
        else:
            np.maximum.at(self.last_msg, dsts, np.maximum(v, 0))
        np.add.at(self.checksum, dsts, v % _MSG_MIX + sk % _SRC_MIX)

    def evict_keys(self, keys: np.ndarray) -> None:
        """An eviction leaves the expected state as it is (a delivery
        re-activates the subscriber); only the cached expansion may go."""
        self._version = -1


def check_chat_exact(engine, n_users: int, mirror: _HostMirror,
                     kind: str = "chat") -> Dict[str, bool]:
    """The subscriber arena against the host replay, exact integer
    equality over the live subscribers (counts, order-free checksums,
    max)."""
    type_name = "ChatUserGrain" if kind == "chat" else "BoardMemberGrain"
    f_recv = "received" if kind == "chat" else "updates"
    f_max = "last_msg" if kind == "chat" else "best_seen"
    arena = engine.arena_for(type_name)
    users = np.arange(n_users, dtype=np.int64)
    rows, live = arena.lookup_rows(users)
    got_recv = arena.state[f_recv].cpu().numpy()[rows]
    got_max = arena.state[f_max].cpu().numpy()[rows]
    got_sum = arena.state["checksum"].cpu().numpy()[rows]
    exp_max = mirror.last_msg if kind == "chat" \
        else np.maximum(mirror.last_msg, 0)
    return {
        "received_exact": bool(
            np.array_equal(got_recv[live], mirror.received[live])),
        "max_exact": bool(np.array_equal(got_max[live], exp_max[live])),
        "checksum_exact": bool(
            np.array_equal(got_sum[live], mirror.checksum[live])),
        "live_subscribers": int(live.sum()),
    }


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def wire_chat(engine, n_rooms: int, n_users: int,
              mean_memberships: float = 3.0, seed: int = 0,
              subs: Optional[DeviceSubscriptions] = None
              ) -> DeviceSubscriptions:
    """Build the room→member adjacency, register it as the engine's
    publish route, pre-activate the members and bind the steady publish
    pattern."""
    if subs is None:
        subs = DeviceSubscriptions(engine, "ChatUserGrain", "receive")
        streams, members = build_membership(n_rooms, n_users,
                                            mean_memberships, seed=seed)
        subs.subscribe_many(streams, members)
    engine.register_subscriptions("ChatRoomGrain", "publish", subs)
    engine.arena_for("ChatUserGrain").reserve(n_users)
    engine.arena_for("ChatUserGrain").resolve_rows(
        np.arange(n_users, dtype=np.int64))
    engine.arena_for("ChatRoomGrain").reserve(n_rooms)
    subs.bind(np.arange(n_rooms, dtype=np.int64))
    return subs


async def run_chat_load(engine, n_rooms: int = 1_000,
                        n_users: int = 100_000,
                        mean_memberships: float = 3.0,
                        n_ticks: int = 16, seed: int = 0,
                        subs: Optional[DeviceSubscriptions] = None,
                        verify: bool = False,
                        mirror: Optional[_HostMirror] = None
                        ) -> Dict[str, float]:
    """Every room publishes one message per tick; members absorb the
    fan-in through the plane.  Events: one publish per room plus one
    delivery per (event, member edge)."""
    subs = wire_chat(engine, n_rooms, n_users, mean_memberships, seed,
                     subs=subs)
    rooms = np.arange(n_rooms, dtype=np.int64)
    injector = engine.make_injector("ChatRoomGrain", "publish", rooms)
    if verify and mirror is None:
        mirror = _HostMirror(subs, n_users)
    edges = subs.edge_count

    msg_base = np.int32(seed * 1_000_000)
    t0 = time.perf_counter()
    for t in range(n_ticks):
        msg_ids = (np.arange(n_rooms, dtype=np.int32)
                   + np.int32(t * n_rooms) + msg_base)
        injector.inject({"msg_id": msg_ids})
        await engine.drain_queues()
        if mirror is not None:
            mirror.publish(rooms, msg_ids.astype(np.int64))
    await engine.flush()
    engine.wait_completion()
    elapsed = time.perf_counter() - t0

    events = (n_rooms + edges) * n_ticks
    stats: Dict[str, float] = {
        "rooms": n_rooms, "users": n_users, "edges": edges,
        "ticks": n_ticks, "seconds": elapsed, "events": events,
        "events_per_sec": events / elapsed,
    }
    if mirror is not None:
        stats["oracle"] = check_chat_exact(engine, n_users, mirror)
        stats["mirror"] = mirror
    return stats


async def run_leaderboard_load(engine, n_boards: int = 512,
                               n_members: int = 100_000,
                               mean_follows: float = 2.0,
                               n_ticks: int = 16, seed: int = 0,
                               verify: bool = False) -> Dict[str, float]:
    """Score rounds: every board posts one score per tick and broadcasts
    it to every follower."""
    rng = np.random.default_rng(seed)
    subs = DeviceSubscriptions(engine, "BoardMemberGrain", "observe")
    streams, members = build_membership(n_boards, n_members, mean_follows,
                                        seed=seed + 1)
    subs.subscribe_many(streams, members)
    engine.register_subscriptions("LeaderboardGrain", "post", subs)
    engine.arena_for("BoardMemberGrain").reserve(n_members)
    engine.arena_for("BoardMemberGrain").resolve_rows(
        np.arange(n_members, dtype=np.int64))
    engine.arena_for("LeaderboardGrain").reserve(n_boards)
    boards = np.arange(n_boards, dtype=np.int64)
    subs.bind(boards)
    injector = engine.make_injector("LeaderboardGrain", "post", boards)
    mirror = _HostMirror(subs, n_members) if verify else None
    edges = subs.edge_count

    scores = [rng.integers(1, 1_000_000, n_boards).astype(np.int32)
              for _ in range(n_ticks)]
    t0 = time.perf_counter()
    for t in range(n_ticks):
        injector.inject({"score": scores[t]})
        await engine.drain_queues()
        if mirror is not None:
            mirror.publish(boards, scores[t].astype(np.int64), kind="board")
    await engine.flush()
    engine.wait_completion()
    elapsed = time.perf_counter() - t0

    events = (n_boards + edges) * n_ticks
    stats: Dict[str, float] = {
        "boards": n_boards, "members": n_members, "edges": edges,
        "ticks": n_ticks, "seconds": elapsed, "events": events,
        "events_per_sec": events / elapsed,
    }
    if mirror is not None:
        stats["oracle"] = check_chat_exact(engine, n_members, mirror,
                                           kind="board")
    return stats


async def run_chat_load_fused(engine, n_rooms: int = 1_000,
                              n_users: int = 100_000,
                              mean_memberships: float = 3.0,
                              n_ticks: int = 32, window: int = 16,
                              seed: int = 0,
                              subs: Optional[DeviceSubscriptions] = None
                              ) -> Dict[str, float]:
    """Chat through a fused program: the publish step, the pull-layout
    gather and the members' fan-in of each window of ticks run as one
    program (on the card one CUDA graph replay), after one untimed warm
    window.  A layout rebuild or a toggle of the plane rebuilds the
    window."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    subs = wire_chat(engine, n_rooms, n_users, mean_memberships, seed,
                     subs=subs)
    rooms = np.arange(n_rooms, dtype=np.int64)
    prog = engine.fuse_ticks("ChatRoomGrain", "publish", rooms)
    edges = subs.edge_count
    window, n_windows, n_ticks = plan_windows(window, n_ticks)
    dev = engine.device

    def stacked_for(base: int) -> Dict[str, torch.Tensor]:
        return {"msg_id": (
            torch.arange(window, dtype=torch.int32, device=dev)[:, None]
            * n_rooms
            + torch.arange(n_rooms, dtype=torch.int32, device=dev)[None]
            + base * n_rooms)}

    prog.run(stacked_for(0))  # untimed warm window (the build)
    engine.wait_completion()
    windows = [stacked_for(w + 1) for w in range(n_windows)]
    engine.wait_completion()

    t0 = time.perf_counter()
    for stacked in windows:
        prog.run(stacked)
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    misses = prog.verify()
    if misses:  # not assert: -O must not skip the exactness check
        raise RuntimeError(f"fused chat window missed {misses} deliveries")

    events = (n_rooms + edges) * n_ticks
    return {
        "rooms": n_rooms, "users": n_users, "edges": edges,
        "ticks": n_ticks, "seconds": elapsed, "events": events,
        "events_per_sec": events / elapsed, "engine": "fused",
    }
