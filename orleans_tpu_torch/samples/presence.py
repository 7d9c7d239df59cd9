"""Presence sample — heartbeat fan-in at 1M-grain scale, on the port.

The torch twin of ``samples/presence.py``: PresenceGrain receives
per-player heartbeats and forwards game status to GameGrain (reference:
Samples/Presence/PresenceGrains/PresenceGrain.cs:40 →
GameGrain.UpdateGameStatus, GameGrain.cs:62; the LoadGenerator project
drives it).  A tick's heartbeats arrive as one (player_key, payload)
slab; player rows update with three row scatters (K3), the game keys of
the emitted updates resolve on the device (K1/K2), and the per-game
fan-in is two segment sums (K4).  The loader only calls ``inject`` per
tick; at steady state the engine's auto-fuser runs the ticks as fused
windows by itself (``tensor/autofuse.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_add_rows,
    scatter_rows,
    seg_sum,
    vector_grain,
)


@vector_grain
class PresenceGrain(VectorGrain):
    """Per-player presence state (reference: PresenceGrain.cs:40)."""

    last_heartbeat = field(torch.int32, 0)   # tick of last heartbeat
    game = field(torch.int32, -1)            # current game key
    heartbeats = field(torch.int32, 0)       # lifetime heartbeat count

    @batched_method
    @staticmethod
    def heartbeat(state, batch: Batch, n_rows: int):
        """Record the heartbeat and forward game status to the game grain
        (reference: PresenceGrain.Heartbeat → GameGrain.UpdateGameStatus).
        ``tick`` may be a host scalar: the scatter broadcasts it."""
        rows, args = batch.rows, batch.args
        ones = torch.ones_like(args["game"], dtype=torch.int32)
        state = {
            **state,
            "last_heartbeat": scatter_rows(state["last_heartbeat"], rows,
                                           args["tick"]),
            "game": scatter_rows(state["game"], rows, args["game"]),
            "heartbeats": scatter_add_rows(state["heartbeats"], rows, ones),
        }
        emit = Emit(
            interface="GameGrain", method="update_game_status",
            keys=args["game"],
            args={"score": args["score"], "count": ones},
            mask=batch.mask)
        return state, None, (emit,)


@vector_grain
class GameGrain(VectorGrain):
    """Per-game aggregate (reference: GameGrain.cs:62)."""

    total_score = field(torch.float32, 0.0)
    updates = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def update_game_status(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        return {
            **state,
            "total_score": state["total_score"]
            + seg_sum(args["score"], rows, n_rows),
            "updates": state["updates"] + seg_sum(args["count"], rows, n_rows),
        }


# ---------------------------------------------------------------------------
# load generator (reference: Samples/Presence/LoadGenerator)
# ---------------------------------------------------------------------------

def presence_inputs(n_players: int, n_games: int, seed: int):
    """The seeded load: (player keys int64, game per player int32, score
    per player float32), drawn exactly as the JAX sample draws them."""
    rng = np.random.default_rng(seed)
    players = np.arange(n_players, dtype=np.int64)
    games = rng.integers(0, n_games, n_players).astype(np.int32)
    scores = rng.random(n_players, dtype=np.float32)
    return players, games, scores


async def run_presence_load(engine, n_players: int = 100_000,
                            n_games: Optional[int] = None,
                            n_ticks: int = 10,
                            seed: int = 0,
                            device_payloads: bool = True,
                            measure_latency: bool = False,
                            warm_ticks: int = 0) -> Dict[str, float]:
    """Drive ``n_ticks`` of heartbeats from every player; returns stats.

    Each tick is 2 logical messages per player (player heartbeat + game
    update), matching how the reference counts Presence traffic.

    ``device_payloads=True`` keeps the heartbeat payload in device memory
    (a colocated load generator); False pays the host→device copy every
    tick.  ``measure_latency=True`` waits for device completion every tick
    and records each tick's inject→completion wall time, so
    ``tick_p99_seconds`` is a true 99th percentile of turn latency; read
    throughput from a pipelined run (``measure_latency=False``).  The
    ``autofuse`` entry says how much of the run the auto-fuser took;
    ``ledger`` and ``attribution`` are the latency ledger's and the
    attribution plane's snapshots, taken after the timed run.
    """
    n_games = n_games or max(1, n_players // 100)
    players, games, scores = presence_inputs(n_players, n_games, seed)

    # pre-size arenas so the measured loop has no growth pauses
    engine.arena_for("PresenceGrain").reserve(n_players)
    engine.arena_for("GameGrain").reserve(n_games)

    # resolve the destination set once (steady-state client edge)
    injector = engine.make_injector("PresenceGrain", "heartbeat", players)

    if device_payloads:
        games_d = torch.from_numpy(games).to(engine.device)
        scores_d = torch.from_numpy(scores).to(engine.device)

        def args_for(t: int):
            # tick rides as a host scalar — broadcast inside the kernel
            return {"game": games_d, "score": scores_d,
                    "tick": np.int32(t + 1)}
    else:
        def args_for(t: int):
            return {"game": games, "score": scores,
                    "tick": np.full(n_players, t + 1, dtype=np.int32)}

    tick_durations = []
    # untimed warm phase through the same injector
    for t in range(warm_ticks):
        injector.inject(args_for(t))
        await engine.drain_queues()
    if warm_ticks:
        await engine.flush()
        engine.wait_completion()

    t0 = time.perf_counter()
    for t in range(n_ticks):
        tick_t0 = time.perf_counter()
        injector.inject(args_for(t))
        if measure_latency:
            # synced mode: the tick's messages, including the game fan-in
            # emitted inside the tick, are applied before the next starts
            await engine.flush()
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - tick_t0)
        else:
            # pipelined dispatch (miss-checks settle at the final flush)
            await engine.drain_queues()
    await engine.flush()
    # wait for the device so the time is real completion, not dispatch
    engine.wait_completion()
    elapsed = time.perf_counter() - t0

    messages = 2 * n_players * n_ticks  # heartbeat + game update per player
    stats: Dict[str, float] = {
        "players": n_players,
        "games": n_games,
        "ticks": n_ticks,
        "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        "mean_tick_seconds": elapsed / n_ticks,
        "autofuse": engine.autofuser.snapshot(),
        "ledger": engine.ledger.snapshot(),
        "attribution": engine.attribution.snapshot(),
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
        stats["tick_max_seconds"] = float(d.max())
    return stats


async def run_presence_load_fused(engine, n_players: int = 100_000,
                                  n_games: Optional[int] = None,
                                  n_ticks: int = 20, window: int = 20,
                                  seed: int = 0,
                                  measure_latency: bool = False
                                  ) -> Dict[str, float]:
    """The same load through a manually driven fused program
    (``engine.fuse_ticks``): windows of up to ``window`` ticks run as one
    program — on the card one CUDA graph replay.  The game assignment and
    scores ride as static args; only the tick counter is per tick.  One
    untimed warm window runs first.  ``measure_latency=True`` uses windows
    of ONE tick and waits for each.  Delivery exactness is checked with
    the program's device miss total."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    n_games = n_games or max(1, n_players // 100)
    rng = np.random.default_rng(seed)
    players = np.arange(n_players, dtype=np.int64)

    engine.arena_for("PresenceGrain").reserve(n_players)
    engine.arena_for("GameGrain").reserve(n_games)
    # steady state: every destination is activated before the window
    engine.arena_for("GameGrain").resolve_rows(
        np.arange(n_games, dtype=np.int64))
    prog = engine.fuse_ticks("PresenceGrain", "heartbeat", players)

    dev = engine.device
    static = {"game": torch.from_numpy(
        rng.integers(0, n_games, n_players).astype(np.int32)).to(dev),
        "score": torch.from_numpy(
            rng.random(n_players, dtype=np.float32)).to(dev)}
    tick_durations = []
    if measure_latency:
        window = 1
    window, n_windows, n_ticks = plan_windows(window, n_ticks)

    def ticks(start: int) -> Dict[str, torch.Tensor]:
        return {"tick": torch.arange(start + 1, start + window + 1,
                                     dtype=torch.int32, device=dev)}

    prog.run(ticks(0), static_args=static)  # warm window
    engine.wait_completion()

    t0 = time.perf_counter()
    for w in range(n_windows):
        w0 = time.perf_counter()
        prog.run(ticks((w + 1) * window), static_args=static)
        if measure_latency:
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - w0)
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    misses = prog.verify()
    if misses:
        raise RuntimeError(
            f"fused window touched {misses} unactivated grains")

    messages = 2 * n_players * n_ticks
    stats: Dict[str, float] = {
        "players": n_players, "games": n_games, "ticks": n_ticks,
        "seconds": elapsed, "messages": messages,
        "messages_per_sec": messages / elapsed,
        "mean_tick_seconds": elapsed / n_ticks,
        "engine": "fused",
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
        stats["tick_max_seconds"] = float(d.max())
    return stats
