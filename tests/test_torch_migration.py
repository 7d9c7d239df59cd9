"""Differential tests of the port's live migration between shard blocks and
of hot-grain replicas over several blocks, against the JAX package.

Twins of tests/test_rebalance.py :224 (migration exact against a
never-migrated oracle, the movers in their pinned blocks), :315 (cached
injector rows go stale at the epoch bump and deliver again to the moved
rows) and :339 (a stream subscription survives a migration), and of the
replica spread over the other blocks (tests/test_replication.py at
``n_shards = 4``).  Both engines take the mesh-less form of the JAX tests
(``engine.n_shards = 4``: shard blocks, no exchange) and run the same numpy
draws; the arenas are compared row for row — the key→row map, each block's
free list and bump pointer, the migration pins, the replica groups — and
the integer state columns exactly.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

import tests.test_rebalance  # noqa: F401 — registers the JAX RebalLedger
from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor.arena import shard_of_keys
from orleans_tpu_torch.tensor.streams_plane import DeviceSubscriptions
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    seg_sum,
    vector_grain,
    vector_type,
)

if vector_type("RebalLedger") is None:
    @vector_grain
    class RebalLedger(VectorGrain):
        balance = field(torch.int32, 0)

        @batched_method
        @staticmethod
        def deposit(state, batch: Batch, n_rows: int):
            return {**state, "balance": state["balance"]
                    + seg_sum(batch.args["amount"], batch.rows,
                              n_rows)}, None, ()


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _engines(n_shards=4):
    """(JAX engine, port engine) with ``n_shards`` logical blocks."""
    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0,
                                                auto_fusion_ticks=0),
                         metrics=JaxMetricsConfig(attribution_enabled=False))
    pe = TensorEngine(config=TensorEngineConfig(auto_fusion_ticks=0),
                      device="cpu",
                      metrics=MetricsConfig(attribution_enabled=False))
    je.n_shards = pe.n_shards = n_shards
    return je, pe


def _balances(engine, keys) -> np.ndarray:
    arena = engine.arena_for("RebalLedger")
    rows, found = arena.lookup_rows(keys)
    assert found.all()
    col = arena.state["balance"]
    if isinstance(col, torch.Tensor):
        return col[torch.from_numpy(rows.astype(np.int64))].numpy()
    return np.asarray(col)[rows]


def _same_arena(ja, pa):
    assert (pa.n_shards, pa.shard_capacity, pa.capacity) == \
        (ja.n_shards, ja.shard_capacity, ja.capacity)
    np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
    np.testing.assert_array_equal(pa._shard_next, ja._shard_next)
    for f, g in zip(pa._free, ja._free):
        np.testing.assert_array_equal(f, g)
    assert pa._shard_override == ja._shard_override
    for attr in ("generation", "eviction_epoch", "live_count",
                 "migrated_count"):
        assert getattr(pa, attr) == getattr(ja, attr), attr
    np.testing.assert_array_equal(pa.state["balance"].numpy(),
                                  np.asarray(ja.state["balance"]))


def test_migration_exact_against_never_migrated_oracle(run):
    """Twin of test_rebalance.py:224: 12 ticks of deposits with two waves
    of 32 moves to random blocks; the port equals the JAX engine row for
    row and the never-migrated oracle in every balance, and every key
    lies in its home (pinned) block."""

    async def drive(engine, oracle):
        rng = np.random.default_rng(7)
        keys = np.arange(128, dtype=np.int64)
        for t in range(12):
            amounts = rng.integers(1, 100, 128).astype(np.int32)
            for e in (engine, oracle):
                e.send_batch("RebalLedger", "deposit", keys,
                             {"amount": amounts})
                e.run_tick()
            if t in (3, 7):
                movers = rng.choice(keys, 32, replace=False)
                engine.migrate_keys("RebalLedger", movers,
                                    rng.integers(0, 4, 32))
        await engine.flush()
        await oracle.flush()

    keys = np.arange(128, dtype=np.int64)
    (je, pe), (_jo, po) = _engines(4), _engines(1)
    run(drive(je, _jo))
    run(drive(pe, po))
    _same_arena(je.arena_for("RebalLedger"), pe.arena_for("RebalLedger"))
    np.testing.assert_array_equal(_balances(pe, keys), _balances(po, keys))
    pa = pe.arena_for("RebalLedger")
    rows, _ = pa.lookup_rows(keys)
    np.testing.assert_array_equal(rows // pa.shard_capacity,
                                  pa.home_shards(keys))
    assert pa._shard_override
    assert pe.grains_migrated == je.grains_migrated > 0
    assert pe.stats()["grains_migrated"] == pe.grains_migrated
    # a pin survives evict → reactivate
    k = np.asarray([next(iter(pa._shard_override))], dtype=np.int64)
    pa.evict_keys(k, write_back=False)
    row = pa.resolve_rows(k)[0]
    assert row // pa.shard_capacity == pa._shard_override[int(k[0])]


def test_inflight_cached_rows_redeliver_after_migration(run):
    """Twin of test_rebalance.py:315: an injector's cached rows go stale
    at the migration's epoch bump; the next inject re-validates and
    delivers to the moved rows — nothing lost, nothing doubled."""

    async def drive(engine):
        keys = np.arange(64, dtype=np.int64)
        inj = engine.make_injector("RebalLedger", "deposit", keys)
        amounts = np.ones(64, np.int32)
        for _ in range(3):
            inj.inject({"amount": amounts})
            engine.run_tick()
        engine.migrate_keys("RebalLedger", keys[:16],
                            (shard_of_keys(keys[:16], 4) + 1) % 4)
        for _ in range(2):
            inj.inject({"amount": amounts})
            engine.run_tick()
        await engine.flush()

    je, pe = _engines(4)
    run(drive(je))
    run(drive(pe))
    keys = np.arange(64, dtype=np.int64)
    assert (_balances(pe, keys) == 5).all()
    _same_arena(je.arena_for("RebalLedger"), pe.arena_for("RebalLedger"))


def test_stream_subscription_survives_migration():
    """Twin of test_rebalance.py:339: a subscribed grain migrates; its
    subscription survives (unlike eviction) and the row-addressed pull
    layout is dirtied for a rebuild; a mover nobody subscribes to only
    advances the layout's stamp."""
    _je, pe = _engines(4)
    arena = pe.arena_for("RebalLedger")
    subs = np.arange(32, dtype=np.int64)
    arena.resolve_rows(np.arange(40, dtype=np.int64))
    route = DeviceSubscriptions(pe, "RebalLedger", "deposit")
    pe.register_subscriptions("RebalLedger", "deposit", route)
    route.subscribe_many(np.full(32, 5, np.int64), subs)
    route._merge_host()
    route._pull_dirty = False  # pretend a built layout
    pe.migrate_keys("RebalLedger", subs[:8],
                    (shard_of_keys(subs[:8], 4) + 2) % 4)
    assert len(route._edges) == 32
    assert route._pull_dirty
    route._pull_dirty = False
    route._pull = {}
    route._pull_stamp = (arena.generation, arena.eviction_epoch)
    pe.migrate_keys("RebalLedger", np.array([35], np.int64),
                    (shard_of_keys(np.array([35]), 4) + 1) % 4)
    assert not route._pull_dirty
    assert route._pull_stamp == (arena.generation, arena.eviction_epoch)


def test_replicas_spread_over_other_blocks_equal_jax(run, jax_trace_shim):
    """Promotion at 4 blocks puts the secondaries on the OTHER blocks,
    round-robin, and the rows equal the JAX arena's; migrate_keys leaves
    a replicated key where it is; a demote folds and frees them."""

    async def drive(engine):
        keys = np.arange(64, dtype=np.int64)
        engine.send_batch("RebalLedger", "deposit", keys,
                          {"amount": np.ones(64, np.int32)})
        await engine.flush()
        arena = engine.arena_for("RebalLedger")
        for key, k in ((5, 4), (17, 3), (40, 6)):
            arena.promote_replicas(key, k)
        assert engine.migrate_keys("RebalLedger", np.array([5], np.int64),
                                   np.array([0], np.int64)) == 0

    je, pe = _engines(4)
    run(drive(je))
    run(drive(pe))
    ja, pa = je.arena_for("RebalLedger"), pe.arena_for("RebalLedger")
    _same_arena(ja, pa)
    for key, rws in ja._replicas.items():
        np.testing.assert_array_equal(pa._replicas[key], rws)
        blocks = rws // ja.shard_capacity
        assert blocks[0] not in set(blocks[1:].tolist())
    np.testing.assert_array_equal(pa._replica_secondary,
                                  ja._replica_secondary)
    for a in (ja, pa):
        a.demote_replicas(17)
    _same_arena(ja, pa)


def test_adopted_layout_keeps_its_block_size_through_growth():
    """A standby that adopts a larger recovery point takes its block size
    with its capacity: traffic to new keys then grows the adopted arena
    (a one-block layout doubles in place) and every balance stays
    exact."""
    from orleans_tpu_torch.samples import banking
    from orleans_tpu_torch.tensor.checkpoint import (
        MemorySnapshotStore,
        StandbyTailer,
    )

    def engine(store=None):
        return TensorEngine(device="cpu", snapshot_store=store,
                            config=TensorEngineConfig(auto_fusion_ticks=0),
                            metrics=MetricsConfig(attribution_enabled=False))

    backing = {}
    primary = engine(MemorySnapshotStore(backing))
    asyncio.run(banking.run_banking_load(primary, banking.make_events(
        4096, 2, lanes=4096, seed=9, transfer_every=0)))
    primary.checkpointer.checkpoint_full()
    keys = np.sort(primary.arena_for("AccountGrain").keys())
    standby = engine()
    StandbyTailer(standby, MemorySnapshotStore(backing)).poll()
    arena = standby.arena_for("AccountGrain")
    assert arena.shard_capacity == arena.capacity
    fresh = np.arange(4096, 4096 + arena.capacity, dtype=np.int64)
    standby.send_batch("AccountGrain", "deposit", fresh,
                       {"amount": np.ones(len(fresh), np.int32)})
    standby.run_tick()
    asyncio.run(standby.flush())
    assert arena.shard_capacity == arena.capacity >= len(keys) + len(fresh)
    np.testing.assert_array_equal(
        banking.read_accounts(standby, keys)["balance"],
        banking.read_accounts(primary, keys)["balance"])
    assert (banking.read_accounts(standby, fresh)["balance"] == 1).all()
