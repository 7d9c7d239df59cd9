"""Chirper sample — power-law follower fan-out, on the port.

The torch twin of ``samples/chirper.py`` (reference: Samples/Chirper —
ChirperAccount publishes a chirp and forwards it to every follower, each
of whom records it; ChirperAccount.cs:129-156 PublishMessage → Followers
loop, NewChirp :261, AddFollower :235).  The follower network (the
sample's NetworkGenerator/NetworkLoader) is power-law: a few celebrity
accounts with huge follower counts, a long tail with few.

The follow graph is a CSR edge table on the device (``DeviceFanout``); a
tick's publishes expand into one flat (follower key, chirp) batch (K11),
and followers absorb the fan-in with segment reductions (K4 sums, K3 MAX
for the newest chirp).  Power-law raggedness stresses what Presence's
uniform fan-in does not: emit widths that vary by orders of magnitude.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.tensor.fanout import DeviceFanout
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    seg_max,
    seg_sum,
    vector_grain,
)


@vector_grain
class ChirperAccount(VectorGrain):
    """Per-account state (reference: ChirperAccount.cs:40 — the publish
    and receive sides of one account grain)."""

    published = field(torch.int32, 0)       # chirps this account published
    received = field(torch.int32, 0)        # chirps received from followees
    last_chirp = field(torch.int32, -1)     # newest chirp id seen
    checksum = field(torch.float32, 0.0)    # delivery checksum (test oracle)

    @batched_method
    @staticmethod
    def publish(state, batch: Batch, n_rows: int):
        """Record the publish; the follower fan-out runs through the
        engine-registered DeviceFanout (reference: PublishMessage's
        Followers loop, ChirperAccount.cs:145-156)."""
        ones = batch.mask.to(torch.int32)
        return {
            **state,
            "published": state["published"]
            + seg_sum(ones, batch.rows, n_rows),
        }

    @batched_method
    @staticmethod
    def new_chirp(state, batch: Batch, n_rows: int):
        """Absorb the fan-in from followed accounts (reference:
        ChirperAccount.NewChirp :261)."""
        rows, args, mask = batch.rows, batch.args, batch.mask
        ones = mask.to(torch.int32)
        chirp = args["chirp_id"].to(torch.int32)
        src = args["src_key"].to(torch.float32) % 97.0
        return {
            **state,
            "received": state["received"] + seg_sum(ones, rows, n_rows),
            "last_chirp": torch.maximum(
                state["last_chirp"],
                seg_max(torch.where(mask, chirp, -1), rows, n_rows)),
            "checksum": state["checksum"]
            + seg_sum(torch.where(mask, src, 0.0), rows, n_rows),
        }


def build_follow_graph(n_accounts: int, mean_followers: float = 20.0,
                       zipf_a: float = 1.6, seed: int = 0,
                       budget: Optional[int] = None) -> DeviceFanout:
    """Power-law follower network (the NetworkGenerator analog): account
    popularity ~ Zipf, so follower counts span orders of magnitude.  The
    same numpy draws as the JAX sample, so one seed gives one graph."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n_accounts) + 1
    weights = ranks.astype(np.float64) ** (-zipf_a)
    weights /= weights.sum()
    n_edges = int(n_accounts * mean_followers)
    publishers = rng.choice(n_accounts, size=n_edges, p=weights)
    followers = rng.integers(0, n_accounts, size=n_edges)
    # drop self-follows and duplicate edges
    keep = publishers != followers
    edges = np.unique(
        np.stack([publishers[keep], followers[keep]], axis=1), axis=0)
    fanout = DeviceFanout(budget=budget or max(1 << 12, 2 * len(edges)))
    fanout.add_edges(edges[:, 0], edges[:, 1])
    return fanout


def _register(engine, n_accounts: int, fanout: DeviceFanout) -> None:
    engine.register_fanout("ChirperAccount", "publish", fanout,
                           "ChirperAccount", "new_chirp")
    engine.arena_for("ChirperAccount").reserve(n_accounts)


async def run_chirper_load(engine, n_accounts: int = 100_000,
                           mean_followers: float = 20.0,
                           n_ticks: int = 10, seed: int = 0,
                           fanout: Optional[DeviceFanout] = None,
                           measure_latency: bool = False
                           ) -> Dict[str, float]:
    """Every account publishes one chirp per tick (chirp id ``t *
    n_accounts + account``); each chirp reaches all followers through the
    device fan-out.  Messages: one publish per account plus one delivery
    per follow edge, per tick.  The loader only injects; at steady state
    the engine's auto-fuser runs the ticks as fused windows by itself."""
    if fanout is None:
        fanout = build_follow_graph(n_accounts, mean_followers, seed=seed)
    _register(engine, n_accounts, fanout)
    accounts = np.arange(n_accounts, dtype=np.int64)
    injector = engine.make_injector("ChirperAccount", "publish", accounts)
    chirp_ids = torch.arange(n_accounts, dtype=torch.int32,
                             device=engine.device)
    tick_durations = []
    t0 = time.perf_counter()
    for t in range(n_ticks):
        tick_t0 = time.perf_counter()
        injector.inject({"chirp_id": chirp_ids + t * n_accounts})
        if measure_latency:
            await engine.flush()
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - tick_t0)
        else:
            await engine.drain_queues()
    await engine.flush()
    engine.wait_completion()
    elapsed = time.perf_counter() - t0

    messages = (n_accounts + fanout.edge_count) * n_ticks
    stats: Dict[str, float] = {
        "accounts": n_accounts,
        "edges": fanout.edge_count,
        "ticks": n_ticks,
        "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        "mean_tick_seconds": elapsed / n_ticks,
        "autofuse": engine.autofuser.snapshot(),
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
    return stats


async def run_chirper_load_fused(engine, n_accounts: int = 100_000,
                                 mean_followers: float = 20.0,
                                 n_ticks: int = 10, window: int = 10,
                                 seed: int = 0,
                                 fanout: Optional[DeviceFanout] = None,
                                 measure_latency: bool = False
                                 ) -> Dict[str, float]:
    """Chirper through a manually driven fused program: publish, the
    follower expansion and the new_chirp fan-in of each window of ticks run
    as one program (on the card one CUDA graph replay), after one untimed
    warm window.  Exactness is checked with the program's miss total."""
    from orleans_tpu_torch.tensor.fused import plan_windows

    if fanout is None:
        fanout = build_follow_graph(n_accounts, mean_followers, seed=seed)
    _register(engine, n_accounts, fanout)
    accounts = np.arange(n_accounts, dtype=np.int64)
    engine.arena_for("ChirperAccount").resolve_rows(accounts)
    prog = engine.fuse_ticks("ChirperAccount", "publish", accounts)
    if measure_latency:
        window = 1
    window, n_windows, n_ticks = plan_windows(window, n_ticks)
    dev = engine.device

    def stacked_for(base: int) -> Dict[str, torch.Tensor]:
        # per-tick chirp ids: one [T, m] leaf
        return {"chirp_id": (
            torch.arange(window, dtype=torch.int32, device=dev)[:, None]
            * n_accounts
            + torch.arange(n_accounts, dtype=torch.int32, device=dev)[None]
            + base * n_accounts)}

    prog.run(stacked_for(0))  # untimed warm window (the build)
    engine.wait_completion()
    # every window's args before timing, as the JAX loader does
    windows = [stacked_for(w + 1) for w in range(n_windows)]
    engine.wait_completion()

    tick_durations = []
    t0 = time.perf_counter()
    for stacked in windows:
        w0 = time.perf_counter()
        prog.run(stacked)
        if measure_latency:
            engine.wait_completion()
            tick_durations.append(time.perf_counter() - w0)
    engine.wait_completion()
    elapsed = time.perf_counter() - t0
    misses = prog.verify()
    if misses:
        raise RuntimeError(
            f"fused window touched {misses} unactivated grains")

    messages = (n_accounts + fanout.edge_count) * n_ticks
    stats: Dict[str, float] = {
        "accounts": n_accounts, "edges": fanout.edge_count,
        "ticks": n_ticks, "seconds": elapsed, "messages": messages,
        "messages_per_sec": messages / elapsed,
        "mean_tick_seconds": elapsed / n_ticks,
        "engine": "fused",
    }
    if tick_durations:
        d = np.asarray(tick_durations)
        stats["tick_p50_seconds"] = float(np.percentile(d, 50))
        stats["tick_p99_seconds"] = float(np.percentile(d, 99))
    return stats
