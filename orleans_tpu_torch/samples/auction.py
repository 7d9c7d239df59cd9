"""Auction sample — time-triggered closings driven by the device timers
plane (``tensor/timers_plane.py``), on the port.

The torch twin of ``samples/auction.py``: every auction registers a
one-shot "close" reminder at listing time; bids stream in as batched
vector calls; when the due tick arrives the wheel harvests every auction
closing that tick in one K15 launch and injects one batched
``receive_reminder`` (reference shape: Orleans auction samples built on
IRemindable + RegisterOrUpdateReminder).  ``bid`` reads the closed flag
with a fill-gather (K13) and raises the price with a float MAX scatter
(K3).

Exactness oracle: closings are deterministic in tick time, so the host
replays the schedule — an auction's final ``highest_bid`` equals the max
over exactly the bids injected before its close tick, every auction
closes exactly once (``closes == 1``), and the accepted and rejected bid
counts match the replay.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    gather_fill,
    scatter_add_rows,
    vector_grain,
)


@vector_grain
class AuctionGrain(VectorGrain):
    """One listing: open bids race a reminder-scheduled closing."""

    highest_bid = field(torch.float32, 0.0)
    bids = field(torch.int32, 0)         # accepted (auction still open)
    closed = field(torch.int32, 0)
    closes = field(torch.int32, 0)       # must end at exactly 1
    late_bids = field(torch.int32, 0)    # rejected (arrived after close)

    @batched_method
    @staticmethod
    def bid(state, batch: Batch, n_rows: int):
        rows, amount = batch.rows, batch.args["amount"]
        # padding rows read "closed", so they never count as open
        open_ = gather_fill(state["closed"], rows, 1) == 0
        live = batch.mask & open_
        ones = live.to(torch.int32)
        late = (batch.mask & ~open_).to(torch.int32)
        return {
            **state,
            "highest_bid": row_scatter(
                state["highest_bid"], rows,
                torch.where(live, amount, float("-inf")), "max"),
            "bids": scatter_add_rows(state["bids"], rows, ones),
            "late_bids": scatter_add_rows(state["late_bids"], rows, late),
        }

    @batched_method
    @staticmethod
    def receive_reminder(state, batch: Batch, n_rows: int):
        """The wheel's batched closing: every auction due this tick."""
        rows = batch.rows
        ones = batch.mask.to(torch.int32)
        return {
            **state,
            # max-with-0 leaves masked lanes untouched
            "closed": row_scatter(state["closed"], rows, ones, "max"),
            "closes": scatter_add_rows(state["closes"], rows, ones),
        }


# ---------------------------------------------------------------------------
# load generator + oracle
# ---------------------------------------------------------------------------

async def run_auction_load(engine, n_auctions: int = 10_000,
                           n_ticks: int = 40, seed: int = 0,
                           verify: bool = True) -> Dict[str, float]:
    """List ``n_auctions`` with staggered close ticks, stream bids every
    EVEN tick, close through the wheel on ODD ticks (so bid-vs-close
    order inside a tick never enters the oracle), then check the
    host-replayed schedule exactly.  The same schedule as the JAX
    sample's, drawn from the same seed."""
    rng = np.random.default_rng(seed)
    keys = np.arange(n_auctions, dtype=np.int64)
    engine.arena_for("AuctionGrain").reserve(n_auctions)

    injector = engine.make_injector("AuctionGrain", "bid", keys)
    injector.inject({"amount": np.zeros(n_auctions, np.float32)})
    engine.run_tick()
    t0 = engine.tick_number

    # odd relative close ticks in [3, n_ticks)
    closes_rel = 3 + 2 * rng.integers(0, max(1, (n_ticks - 3) // 2),
                                      n_auctions)
    engine.timers.arm_batch("AuctionGrain", keys,
                            t0 + closes_rel.astype(np.int64), 0, "close")

    best = np.full(n_auctions, 0.0, np.float32)   # host oracle replay
    accepted = np.zeros(n_auctions, np.int64)
    rejected = np.zeros(n_auctions, np.int64)
    for t in range(1, n_ticks + 1):
        if t % 2 == 0:
            amounts = rng.random(n_auctions, dtype=np.float32) * 100
            injector.inject({"amount": amounts})
            # the initial zero-amount activation bid counted too
            open_ = t < closes_rel
            best = np.where(open_, np.maximum(best, amounts), best)
            accepted += open_
            rejected += ~open_
        engine.run_tick()
    await engine.flush()

    arena = engine.arena_for("AuctionGrain")
    rows, found = arena.lookup_rows(keys)
    got = {n: c.cpu().numpy()[rows] for n, c in arena.state.items()}
    stats = {
        "auctions": n_auctions,
        "closed": int(got["closed"].sum()),
        "late_bids": int(got["late_bids"].sum()),
        "exact": bool(
            found.all()
            and (got["closes"] == 1).all()
            and (got["closed"] == 1).all()
            and (got["bids"] == accepted + 1).all()   # +1: activation
            and (got["late_bids"] == rejected).all()
            and np.allclose(got["highest_bid"], best)),
    }
    if verify:
        assert stats["exact"], {
            "closes": np.unique(got["closes"]).tolist(),
            "late_mismatch": int((got["late_bids"] != rejected).sum()),
            "accept_mismatch": int(
                (got["bids"] != accepted + 1).sum()),
            "bid_mismatches": int(
                (~np.isclose(got["highest_bid"], best)).sum())}
    return stats
