"""Routing workload, on the port.

The torch twin of ``samples/routing.py``: a two-type pipeline whose one
tunable is where the destinations lie.  ``RouteSource.send`` counts the
source's sends and emits one message per lane to the ``RouteSink`` key
in its ``dst`` argument; ``RouteSink.recv`` sums the values and counts
the messages.  Both columns of the sink are pure sums and ``recv`` is
declared ``@commutative``, so a hot sink can be promoted to replica rows
(``TensorEngine.replicate_key``) and its fold stays exact: the
single-hot-grain load (every source sends to one sink, Zipf s→∞) is the
case replicas exist for.

The multichip bench's ratio sweep: ``build_ratio_destinations`` picks
the destinations so that exactly ``round(cross_ratio * n)`` sources send
to a sink in another shard block than their own (by ``shard_of_keys``),
and ``run_routing_load`` drives the pipeline over the engine's
``n_shards`` blocks (a ``ShardMesh``, tensor/mesh.py), through the
cross-shard exchange when the engine runs one.  Both handlers combine
with ``seg_sum``, so the exchange's lane permutation cannot change the
result: integer-valued float payloads make the sink state exact against
``expected_sink_state`` and against an exchange-off run.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from orleans_tpu_torch.core.grain import batched_method, commutative
from orleans_tpu_torch.tensor.arena import shard_of_keys
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    Emit,
    VectorGrain,
    field,
    scatter_add_rows,
    seg_sum,
    vector_grain,
)

#: sink keys start here (disjoint from the source key space so the two
#: arenas never alias); readers derive the sink set from it
SINK_BASE = 1 << 20


def sink_keys(n_sinks: int) -> np.ndarray:
    return np.arange(SINK_BASE, SINK_BASE + n_sinks, dtype=np.int64)


@vector_grain
class RouteSource(VectorGrain):
    """Per-producer state: counts its own sends."""

    sent = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def send(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        ones = torch.ones(rows.shape[0], dtype=torch.int32,
                          device=rows.device)
        state = {**state,
                 "sent": scatter_add_rows(state["sent"], rows, ones)}
        emit = Emit(interface="RouteSink", method="recv",
                    keys=args["dst"],
                    args={"v": args["v"], "count": ones},
                    mask=batch.mask)
        return state, None, (emit,)


@vector_grain
class RouteSink(VectorGrain):
    """Per-consumer aggregate (order-free fan-in); ``recv`` is commutative,
    so a hot sink may be replicated and its fold is exact."""

    total = field(torch.float32, 0.0)
    received = field(torch.int32, 0)

    @batched_method
    @staticmethod
    @commutative
    def recv(state, batch: Batch, n_rows: int):
        rows, args = batch.rows, batch.args
        return {**state,
                "total": state["total"] + seg_sum(args["v"], rows, n_rows),
                "received": state["received"]
                + seg_sum(args["count"], rows, n_rows)}


def build_ratio_destinations(sources: np.ndarray, sinks: np.ndarray,
                             n_shards: int, cross_ratio: float,
                             seed: int = 0) -> np.ndarray:
    """One destination sink key per source, with exactly
    ``round(cross_ratio * n)`` of them in a different shard than their
    source (by ``shard_of_keys``); the same draws as the JAX function.
    Every shard needs at least one sink."""
    rng = np.random.default_rng(seed)
    src_shard = shard_of_keys(sources, n_shards)
    sink_shard = shard_of_keys(sinks, n_shards)
    by_shard = [sinks[sink_shard == s] for s in range(n_shards)]
    if any(len(b) == 0 for b in by_shard):
        raise ValueError("every shard needs at least one sink key")
    n = len(sources)
    cross = np.zeros(n, dtype=bool)
    n_cross = int(round(cross_ratio * n))
    cross[rng.choice(n, size=n_cross, replace=False)] = True
    dst = np.empty(n, dtype=np.int64)
    for s in range(n_shards):
        mine = src_shard == s
        # same-shard picks come from the source's own block; cross picks
        # from a uniformly random other block
        local_pool = by_shard[s]
        idx = np.nonzero(mine & ~cross)[0]
        dst[idx] = local_pool[rng.integers(0, len(local_pool), len(idx))]
        idx = np.nonzero(mine & cross)[0]
        if len(idx):
            others = rng.integers(0, n_shards - 1, len(idx))
            others = others + (others >= s)
            for o in range(n_shards):
                sel = idx[others == o]
                if len(sel):
                    pool = by_shard[o]
                    dst[sel] = pool[rng.integers(0, len(pool), len(sel))]
    return dst


async def run_routing_load(engine, n_sources: int, n_sinks: int,
                           cross_ratio: float, n_ticks: int = 10,
                           seed: int = 0, warm_ticks: int = 2,
                           fused_window: int = 0) -> Dict[str, float]:
    """Drive ``n_ticks`` of the routing pipeline at a fixed cross-shard
    ratio over the engine's shard blocks; returns stats (2 logical
    messages per source per tick: the send and the delivery).
    ``fused_window > 0`` runs the steady state as fused windows of that
    length (exactness checked with the window miss count); 0 drives the
    unfused tick through a cached injector."""
    sources = np.arange(n_sources, dtype=np.int64)
    sinks = sink_keys(n_sinks)
    dst = build_ratio_destinations(sources, sinks, engine.n_shards,
                                   cross_ratio, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # integer-valued floats: seg_sum order cannot perturb the total
    values = rng.integers(1, 8, n_sources).astype(np.float32)

    engine.arena_for("RouteSource").reserve(n_sources)
    engine.arena_for("RouteSink").reserve(n_sinks)
    engine.arena_for("RouteSource").resolve_rows(sources)
    engine.arena_for("RouteSink").resolve_rows(sinks)

    dev = engine.device
    dst_d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    values_d = torch.from_numpy(values).to(dev)

    if fused_window > 0:
        from orleans_tpu_torch.tensor.fused import plan_windows

        window, n_windows, n_ticks = plan_windows(fused_window, n_ticks)
        prog = engine.fuse_ticks("RouteSource", "send", sources)
        static = {"dst": dst_d, "v": values_d}
        ticks = torch.arange(window, dtype=torch.int32, device=dev)
        # warm window 1 builds at the worst-case fallback caps (no demand
        # measured yet); its verify folds the measured demand into the
        # estimators, so warm window 2 rebuilds at the sized caps (cause
        # bucket_growth), both outside the timed segment
        prog.run({"tick": ticks}, static_args=static)
        engine.wait_completion()
        misses = prog.verify()
        prog.run({"tick": ticks + window}, static_args=static)
        engine.wait_completion()
        misses += prog.verify()
        if misses:  # not assert: -O must not skip the exactness check
            raise RuntimeError(
                f"fused routing warm-up missed {misses} deliveries")
        rebuilds0 = sum(prog.rebuilds.values())
        live0, pad0 = _exchange_lanes(engine)
        stacked = [{"tick": ticks + (w + 2) * window}
                   for w in range(n_windows)]
        t0 = time.perf_counter()
        for st in stacked:
            prog.run(st, static_args=static)
        engine.wait_completion()
        elapsed = time.perf_counter() - t0
        misses = prog.verify()
        if misses:
            raise RuntimeError(
                f"fused routing window missed {misses} deliveries")
        if sum(prog.rebuilds.values()) != rebuilds0:
            raise RuntimeError(
                "fused routing steady state rebuilt mid-run (cap "
                "re-quantization must settle in warm-up)")
        engine_kind = "fused"
    else:
        injector = engine.make_injector("RouteSource", "send", sources)

        def args_for(t: int):
            return {"dst": dst_d, "v": values_d, "tick": np.int32(t)}

        warm_total = warm_ticks
        for t in range(warm_ticks):
            injector.inject(args_for(t))
            await engine.drain_queues()
        await engine.flush()
        if warm_ticks > 0:
            # the flush drained the parked exchange stats, so the
            # estimators size the steady-state caps: one more warm tick
            # runs at them, outside the timed segment
            injector.inject(args_for(warm_ticks))
            await engine.drain_queues()
            await engine.flush()
            warm_total += 1
        engine.wait_completion()
        live0, pad0 = _exchange_lanes(engine)
        t0 = time.perf_counter()
        for t in range(n_ticks):
            injector.inject(args_for(warm_total + t))
            await engine.drain_queues()
        await engine.flush()
        engine.wait_completion()
        elapsed = time.perf_counter() - t0
        engine_kind = "unfused"

    messages = 2 * n_sources * n_ticks
    xs = engine.stats().get("exchange") or {}
    live1, pad1 = _exchange_lanes(engine)
    # steady-state utilization over the timed segment only (the warm-up
    # runs the worst-case caps while demand is being measured)
    steady_util = round((live1 - live0) / (pad1 - pad0), 4) \
        if pad1 > pad0 else xs.get("bucket_utilization")
    return {
        "sources": n_sources,
        "sinks": n_sinks,
        "cross_ratio": cross_ratio,
        "ticks": n_ticks,
        # warm + timed: the denominator for the per-tick state oracles
        "total_ticks": n_ticks + (2 * window if fused_window > 0
                                  else warm_total),
        "seconds": elapsed,
        "messages": messages,
        "messages_per_sec": messages / elapsed,
        "engine": engine_kind,
        "bucket_utilization": steady_util,
        "exchange_overlap_s": xs.get("overlap_seconds"),
        "exchange_caps": xs.get("sites"),
    }


def _exchange_lanes(engine) -> Tuple[int, int]:
    xch = getattr(engine, "exchange", None)
    if xch is None:
        return 0, 0
    return xch.live_lanes, xch.padded_lanes


def expected_sink_state(sources: np.ndarray, dst: np.ndarray,
                        values: np.ndarray, sinks: np.ndarray,
                        n_ticks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side ground truth: (total float64, received int64) per sink
    key after ``n_ticks`` ticks."""
    order = np.searchsorted(sinks, dst)
    total = np.zeros(len(sinks), np.float64)
    np.add.at(total, order, values.astype(np.float64))
    received = np.zeros(len(sinks), np.int64)
    np.add.at(received, order, 1)
    return total * n_ticks, received * n_ticks
