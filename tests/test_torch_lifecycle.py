"""Differential tests of the port's grain lifecycle against the JAX package:
idle collection with store write-back, free-list reuse, compaction,
reactivation through the store and the attribution plane's retirement of
evicted rows.

Kernels: K12 ``idle_mask`` and K13 ``gather_rows`` (plain versions on the
CPU) against ``_idle_mask_kernel`` and ``_gather_counts``, and K3's use as
``_zero_rows``, on the same seeded numpy inputs; all exact.

Engines: twins of tests/test_collection.py.  Each scenario runs once on a
JAX engine and once on a port engine (``device="cpu"``), both with their
defaults (the latency ledger and the attribution plane on), asserting the
JAX test's own properties on both; then the two are compared bit for bit:
the key→row map, the free list and bump pointer, the state columns (the
float column too: every addend is a small integer, exact in float32),
the device use clock, the host use clock of live rows, the counters, the
store records and the attribution plane's per-key totals.  The mesh,
provider-bridge, span and telemetry cases of tests/test_collection.py are
not twinned: the port has one shard block per card and no host storage
providers, span recorder or telemetry plane yet.

The installed JAX lacks ``jax.core.trace_state_clean``, which the JAX
plane's eviction path calls (``on_evict`` → ``flush_folds``): the
``jax_trace_shim`` fixture sets it per test, as in
tests/test_torch_attribution.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.presence  # noqa: F401 — registers the JAX Presence grains
import tests.test_tensor_engine  # noqa: F401 — registers JAX AccumGrain
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import MemoryVectorStore as JaxMemoryVectorStore
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor.arena import _idle_mask_kernel
from orleans_tpu.tensor.attribution import _gather_counts, _zero_rows

import orleans_tpu_torch.samples.presence  # noqa: F401 — port Presence
import tests.test_torch_presence  # noqa: F401 — registers port AccumGrain
from orleans_tpu_torch.config import TensorEngineConfig
from orleans_tpu_torch.kernels.lifecycle import (
    gather_rows,
    gather_rows_plain,
    idle_mask,
    idle_mask_plain,
)
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.device import pow2_pad
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

I32 = np.iinfo(np.int32)


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


# -- the kernels --------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 4096])
def test_idle_mask_matches_jax(n):
    """K12 (plain) against ``_idle_mask_kernel`` with both clocks and the
    cutoff at the int32 edges the arena clips to."""
    rng = np.random.default_rng(n)
    dev = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    host = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    dev[:n // 4] = rng.integers(0, 64, n // 4)
    host[:n // 3] = rng.integers(0, 64, n // 3)
    host[-1:] = I32.max
    live = rng.random(n) < 0.7
    for cutoff in (-2**31 + 1, 0, 32, 2**30, 2**31 - 1):
        want = np.asarray(_idle_mask_kernel(
            jnp.asarray(dev), jnp.asarray(host), jnp.asarray(live),
            jnp.int32(cutoff)))
        got = idle_mask(torch.from_numpy(dev), torch.from_numpy(host),
                        torch.from_numpy(live), cutoff)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            idle_mask_plain(torch.from_numpy(dev), torch.from_numpy(host),
                            torch.from_numpy(live), cutoff).numpy(), want)


@pytest.mark.parametrize("width", [(), (3,)])
def test_gather_rows_matches_jax_gather_counts(width):
    """K13 (plain) against ``_gather_counts`` on pow2-padded rows (pad
    lanes read row 0), out-of-range rows clipped, int32 and float32."""
    rng = np.random.default_rng(7)
    n = 300
    rows = pow2_pad(rng.integers(0, n, 77).astype(np.int32), 0)
    rows[3], rows[5] = -4, n + 9  # clipped into [0, n)
    for dtype in (np.int32, np.float32):
        col = (rng.standard_normal((n, *width)) * 1000).astype(dtype)
        want = np.asarray(_gather_counts(jnp.asarray(col),
                                         jnp.asarray(rows)))
        got = gather_rows(torch.from_numpy(col), torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            gather_rows_plain(torch.from_numpy(col),
                              torch.from_numpy(rows)).numpy(), want)


def test_zero_rows_through_k3_matches_jax():
    """``_zero_rows`` (a drop-mode SET of 0) is K3 SET with a host scalar
    0: the same column, pad lanes (capacity) dropped."""
    rng = np.random.default_rng(3)
    cap = 257
    counts = rng.integers(0, 1000, cap).astype(np.int32)
    victims = rng.choice(cap, 50, replace=False).astype(np.int32)
    idx = pow2_pad(victims, cap)
    want = np.asarray(_zero_rows(jnp.asarray(counts), jnp.asarray(idx)))
    got = torch.from_numpy(counts.copy())
    row_scatter(got, torch.from_numpy(idx), 0, "set")
    np.testing.assert_array_equal(got.numpy(), want)


# -- twins of tests/test_collection.py ----------------------------------------

class _FlakyMixin:
    """Fails the next ``fail_next`` columnar writes (the chaos storage
    seam's ``fail`` action as the tensor bridge sees it)."""

    def __init__(self):
        super().__init__()
        self.fail_next = 0
        self.columnar_writes = 0

    def write_many_columnar(self, type_name, keys, columns):
        self.columnar_writes += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            raise IOError("chaos: injected storage write failure")
        super().write_many_columnar(type_name, keys, columns)


class _JaxFlaky(_FlakyMixin, JaxMemoryVectorStore):
    pass


class _PortFlaky(_FlakyMixin, MemoryVectorStore):
    pass


_SHARED = ("collection_idle_ticks", "collection_every_ticks",
           "collection_pause_budget_s", "collection_chunk_rows",
           "compact_fragmentation_threshold", "auto_fusion_ticks",
           "auto_fusion_window")


def _sides(store=None, initial_capacity=64, **cfg):
    """The JAX side and the port side of one scenario: each a namespace
    with ``engine``, ``store`` and ``keys_dev`` (device int32 keys)."""
    assert set(cfg) <= set(_SHARED), cfg
    mk = {None: (lambda: None, lambda: None),
          "memory": (JaxMemoryVectorStore, MemoryVectorStore),
          "flaky": (_JaxFlaky, _PortFlaky)}[store]
    jstore, pstore = mk[0](), mk[1]()
    j = types.SimpleNamespace(
        engine=JaxTensorEngine(config=JaxEngineConfig(**cfg), store=jstore,
                               initial_capacity=initial_capacity),
        store=jstore, keys_dev=lambda a: jnp.asarray(a, jnp.int32))
    p = types.SimpleNamespace(
        engine=TensorEngine(config=TensorEngineConfig(**cfg), store=pstore,
                            initial_capacity=initial_capacity,
                            device="cpu"),
        store=pstore, keys_dev=lambda a: torch.as_tensor(
            np.asarray(a, np.int32)))
    return j, p


def _add(engine, keys, v=1.0):
    engine.send_batch("AccumGrain", "add", np.asarray(keys, dtype=np.int64),
                      {"v": np.full(len(keys), v, np.float32)})


def _total(arena, key) -> float:
    return float(arena.read_row(key)["total"])


def _assert_arena_twins(je, pe, type_name):
    ja, pa = je.arena_for(type_name), pe.arena_for(type_name)
    assert ja.n_shards == 1
    assert ja.capacity == pa.capacity
    np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
    np.testing.assert_array_equal(pa._free[0], ja._free[0])
    np.testing.assert_array_equal(pa._shard_next, ja._shard_next)
    for attr in ("live_count", "evicted_count", "restored_count",
                 "eviction_epoch", "generation"):
        assert getattr(pa, attr) == getattr(ja, attr), attr
    for name, col in ja.state.items():
        np.testing.assert_array_equal(pa.state[name].cpu().numpy(),
                                      np.asarray(col), err_msg=name)
    np.testing.assert_array_equal(pa.last_use_dev.cpu().numpy(),
                                  np.asarray(ja.last_use_dev))
    live = np.flatnonzero(ja._key_of_row >= 0)
    np.testing.assert_array_equal(pa.last_use(live), ja.last_use_tick[live])


def _assert_twins(j, p, type_names=("AccumGrain",)):
    je, pe = j.engine, p.engine
    for t in type_names:
        _assert_arena_twins(je, pe, t)
        if je.attribution.has_state(t):
            assert pe.attribution.per_key_totals(t) == \
                je.attribution.per_key_totals(t), t
    for attr in ("tick_number", "messages_processed", "activation_passes"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    jc, pc = je.collector.snapshot(), pe.collector.snapshot()
    assert set(pc) == set(jc)
    for k in ("sweeps_started", "sweeps_completed", "slices_run",
              "rows_evicted", "victims_dropped_stale", "pending_rows",
              "write_back_failures"):
        assert pc[k] == jc[k], k
    if j.store is not None:
        for t in type_names:
            keys = j.store.list_keys(t)
            np.testing.assert_array_equal(p.store.list_keys(t), keys)
            jr = j.store.read_many(t, keys.tolist())
            pr = p.store.read_many(t, keys.tolist())
            for k in keys.tolist():
                assert set(pr[k]) == set(jr[k])
                for f, v in jr[k].items():
                    np.testing.assert_array_equal(pr[k][f], v)


def _twin(run, scenario, type_names=("AccumGrain",), **kw):
    j, p = _sides(**kw)
    run(scenario(j))
    run(scenario(p))
    _assert_twins(j, p, type_names)
    return j, p


def test_eviction_preserves_generation_and_bumps_epoch(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(16), v=2.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        gen0, epoch0 = arena.generation, arena.eviction_epoch
        engine.tick_number += 100
        arena.resolve_rows(np.arange(8, dtype=np.int64),
                           tick=engine.tick_number)
        assert engine.collect_idle(max_idle_ticks=50) == 8
        assert arena.generation == gen0
        assert arena.eviction_epoch > epoch0
        assert _total(arena, 3) == 2.0

    _twin(run, go, store="memory")


def test_freed_slots_reused_in_place(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(32), v=9.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        arena.compact_fragmentation = 0.0
        cap0, gen0 = arena.capacity, arena.generation
        rows_before = set(
            arena.resolve_rows(np.arange(32, dtype=np.int64)).tolist())
        engine.tick_number += 100
        assert engine.collect_idle(50, write_back=False) == 32
        _add(engine, range(100, 132), v=1.0)
        await engine.flush()
        rows_after = set(arena.resolve_rows(
            np.arange(100, 132, dtype=np.int64)).tolist())
        assert rows_after == rows_before
        assert arena.capacity == cap0 and arena.generation == gen0
        assert _total(arena, 100) == 1.0
        assert int(arena.read_row(100)["count"]) == 1

    _twin(run, go)


def test_free_list_survives_grow(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(24), v=5.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        engine.tick_number += 100
        arena.resolve_rows(np.arange(8, dtype=np.int64),
                           tick=engine.tick_number)
        assert engine.collect_idle(50, write_back=False) == 16
        assert sum(len(f) for f in arena._free) == 16
        _add(engine, range(1000, 1060), v=1.0)
        await engine.flush()
        assert arena.capacity > 32
        assert _total(arena, 3) == 5.0 and _total(arena, 1005) == 1.0
        keys = arena.keys()
        assert len(set(arena.resolve_rows(keys).tolist())) == len(keys)

    _twin(run, go, initial_capacity=32)


def test_fragmentation_threshold_triggers_compact(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(40), v=1.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        arena.compact_fragmentation = 0.5
        gen0 = arena.generation
        engine.tick_number += 100
        arena.resolve_rows(np.arange(4, dtype=np.int64),
                           tick=engine.tick_number)
        assert engine.collect_idle(50, write_back=False) == 36
        assert arena.generation > gen0
        assert arena.fragmentation() == 0.0
        assert sum(len(f) for f in arena._free) == 0
        assert _total(arena, 2) == 1.0

    _twin(run, go, compact_fragmentation_threshold=0.5)


def test_injector_survives_foreign_eviction_without_reresolve(
        run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(16), v=1.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        hot = np.arange(8, dtype=np.int64)
        inj = engine.make_injector("AccumGrain", "add", hot)
        cached_rows = inj.rows
        engine.tick_number += 100
        arena.resolve_rows(hot, tick=engine.tick_number)
        assert engine.collect_idle(50) == 8
        inj.inject({"v": np.ones(8, np.float32)})
        await engine.flush()
        assert inj.rows is cached_rows  # no re-resolve, no re-upload
        assert inj.generation == arena.generation
        assert inj.epoch == arena.eviction_epoch
        assert _total(arena, 0) == 2.0

    _twin(run, go, store="memory")


def test_injector_over_evicted_key_reactivates_through_store(
        run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        keys = np.arange(4, dtype=np.int64)
        inj = engine.make_injector("AccumGrain", "add", keys)
        inj.inject({"v": np.full(4, 3.0, np.float32)})
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        engine.tick_number += 100
        assert engine.collect_idle(50) == 4
        assert len(s.store.list_keys("AccumGrain")) == 4
        inj.inject({"v": np.ones(4, np.float32)})
        await engine.flush()
        assert _total(arena, 2) == 4.0
        assert arena.restored_count == 4

    _twin(run, go, store="memory")


def test_injector_key_reactivated_in_different_slot(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        arena = engine.arena_for("AccumGrain")
        arena.compact_fragmentation = 0.0
        keys = np.arange(4, dtype=np.int64)
        inj = engine.make_injector("AccumGrain", "add", keys)
        inj.inject({"v": np.full(4, 2.0, np.float32)})
        await engine.flush()
        old_rows = arena.resolve_rows(keys).copy()
        engine.tick_number += 100
        assert engine.collect_idle(50) == 4
        _add(engine, range(100, 104), v=7.0)
        await engine.flush()
        usurped = arena.resolve_rows(np.arange(100, 104, dtype=np.int64))
        assert set(usurped.tolist()) == set(old_rows.tolist())
        arena.resolve_rows(keys, tick=engine.tick_number)  # reactivate
        inj.inject({"v": np.ones(4, np.float32)})
        await engine.flush()
        for k in range(100, 104):
            assert _total(arena, k) == 7.0
        for k in range(4):
            assert _total(arena, k) == 3.0

    _twin(run, go, store="memory")


def test_collect_idle_completes_across_threshold_compaction(
        run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(1000), v=1.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        assert arena.compact_fragmentation == 0.75
        engine.tick_number += 100
        assert engine.collect_idle(50) == 1000
        assert arena.live_count == 0
        assert engine.collector.victims_dropped_stale > 0

    _twin(run, go, store="memory", collection_chunk_rows=32)


def test_evict_while_pending_batch_targets_victim(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(8), v=5.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        engine.send_batch("AccumGrain", "add",
                          s.keys_dev(np.array([7])),
                          {"v": np.ones(1, np.float32)})
        engine.tick_number += 100
        arena.resolve_rows(np.arange(7, dtype=np.int64),
                           tick=engine.tick_number)
        assert engine.collect_idle(50) == 1
        await engine.flush()
        assert _total(arena, 7) == 6.0
        assert arena.restored_count == 1

    _twin(run, go, store="memory")


def test_write_back_false_discards_state(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(4), v=7.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        engine.tick_number += 100
        assert engine.collect_idle(50, write_back=False) == 4
        assert len(s.store.list_keys("AccumGrain")) == 0
        _add(engine, [2], v=1.0)
        await engine.flush()
        assert _total(arena, 2) == 1.0

    _twin(run, go, store="memory")


def test_storage_fault_mid_chunk_keeps_victims_live(run, jax_trace_shim):
    async def go(s):
        engine, store = s.engine, s.store
        _add(engine, range(12), v=4.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        live0 = arena.live_count
        engine.tick_number += 100
        store.fail_next = 2
        engine.collector.start_sweep(engine.tick_number - 50)
        evicted = engine.collector.run_slice(0.0, chunk_rows=4)
        assert engine.collector.write_back_failures == 1
        assert arena.live_count == live0 - evicted
        assert engine.collector.active()
        assert _total(arena, 0) == 4.0
        store.fail_next = 0
        while engine.collector.active():
            engine.collector.run_slice(0.0, chunk_rows=4)
        assert arena.live_count == 0
        assert len(store.list_keys("AccumGrain")) == 12
        _add(engine, [11], v=1.0)
        await engine.flush()
        assert _total(arena, 11) == 5.0

    j, p = _twin(run, go, store="flaky")
    assert p.store.columnar_writes == j.store.columnar_writes


def test_synchronous_collect_propagates_storage_fault(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(6), v=1.0)
        await engine.flush()
        engine.tick_number += 100
        s.store.fail_next = 10**9
        with pytest.raises(IOError):
            engine.collect_idle(50)
        assert engine.arena_for("AccumGrain").live_count == 6

    _twin(run, go, store="flaky")


def test_tick_interleaved_collection_bounded_slices(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(128), v=1.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        hot = np.arange(8, dtype=np.int64)
        inj = engine.make_injector("AccumGrain", "add", hot)
        engine.tick_number += 100
        evicted_by_tick = []
        for _ in range(24):
            inj.inject({"v": np.ones(8, np.float32)})
            engine.run_tick()
            evicted_by_tick.append(arena.evicted_count)
        await engine.flush()
        assert arena.evicted_count == 120
        assert arena.live_count == 8
        assert sum(1 for a, b in zip(evicted_by_tick, evicted_by_tick[1:])
                   if b > a) >= 3
        assert engine.collector.slices_run >= 3
        assert _total(arena, 0) >= 24.0
        s.evicted_by_tick = evicted_by_tick

    j, p = _twin(run, go, store="memory", initial_capacity=256,
                 collection_idle_ticks=10, collection_every_ticks=8,
                 collection_pause_budget_s=1e-9, collection_chunk_rows=16)
    assert p.evicted_by_tick == j.evicted_by_tick


def test_columnar_write_back_per_grain_records(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        keys = np.arange(6, dtype=np.int64)
        engine.send_batch("AccumGrain", "add", keys,
                          {"v": np.arange(6, dtype=np.float32)})
        await engine.flush()
        engine.tick_number += 100
        assert engine.collect_idle(50) == 6
        rows = s.store.read_many("AccumGrain", [0, 3, 5])
        assert float(rows[3]["total"]) == 3.0
        assert float(rows[5]["total"]) == 5.0
        assert int(rows[0]["count"]) == 1

    _twin(run, go, store="memory")


def test_autofused_pattern_survives_foreign_eviction(run, jax_trace_shim):
    async def go(s):
        engine = s.engine
        _add(engine, range(16), v=1.0)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        gen0 = arena.generation
        hot = np.arange(8, dtype=np.int64)
        inj = engine.make_injector("AccumGrain", "add", hot)
        for _ in range(24):
            inj.inject({"v": np.ones(8, np.float32)})
            engine.run_tick()
        await engine.flush()
        assert engine.autofuser.windows_run >= 1
        engine.tick_number += 100
        arena.resolve_rows(hot, tick=engine.tick_number)
        assert engine.collect_idle(50) == 8
        assert arena.generation == gen0
        for _ in range(24):
            inj.inject({"v": np.ones(8, np.float32)})
            engine.run_tick()
        await engine.flush()
        assert _total(arena, 0) == 1.0 + 48.0
        s.windows = engine.autofuser.windows_run

    j, p = _twin(run, go, store="memory", auto_fusion_ticks=4,
                 auto_fusion_window=4)
    assert p.windows == j.windows


# -- a Presence slice with collection on, key by key --------------------------

def _presence_payload(games, ks, tick):
    return {"game": games[:len(ks)],
            "score": np.ones(len(ks), np.float32),
            "tick": np.full(len(ks), tick, np.int32)}


async def _presence_collection(s, n, hot):
    """bench.py's collection scenario at a small size: all players
    activate, a hot subset keeps beating while the tick-interleaved
    collector evicts the idle majority with write-back, then an evicted
    player re-activates through the store."""
    engine = s.engine
    keys = np.arange(n, dtype=np.int64)
    games = (keys % max(1, n // 100)).astype(np.int32)

    def drive(inj, ticks):
        for _ in range(ticks):
            inj.inject(_presence_payload(games, inj.keys,
                                         engine.tick_number))
            engine.run_tick()

    drive(engine.make_injector("PresenceGrain", "heartbeat", keys), 4)
    await engine.flush()
    hot_inj = engine.make_injector("PresenceGrain", "heartbeat", keys[:hot])
    arena = engine.arena_for("PresenceGrain")
    gen0 = arena.generation
    for _ in range(5):
        drive(hot_inj, 8)
        await engine.flush()
    assert arena.evicted_count == n - hot
    assert arena.live_count == hot and arena.generation == gen0
    probe = int(keys[-1])
    engine.send_batch("PresenceGrain", "heartbeat",
                      np.array([probe], dtype=np.int64),
                      _presence_payload(games, [probe], 0))
    await engine.flush()
    assert int(arena.read_row(probe)["heartbeats"]) == 5
    assert arena.restored_count == 1


def test_presence_slice_with_collection_matches_jax(run, jax_trace_shim):
    _twin(run, lambda s: _presence_collection(s, 400, 40),
          type_names=("PresenceGrain", "GameGrain"), store="memory",
          initial_capacity=1024, auto_fusion_ticks=0,
          collection_idle_ticks=24, collection_every_ticks=8,
          collection_pause_budget_s=0.0, collection_chunk_rows=128,
          compact_fragmentation_threshold=0.0)


def test_presence_slice_crosses_compaction_matches_jax(run, jax_trace_shim):
    """The same slice at the default threshold 0.75: the sweep crosses
    into ``_compact`` (rows move, the generation bumps, the attribution
    counts move with their rows)."""

    async def go(s):
        engine = s.engine
        n, hot = 200, 20
        keys = np.arange(n, dtype=np.int64)
        games = (keys % 4).astype(np.int32)
        inj = engine.make_injector("PresenceGrain", "heartbeat", keys)
        inj.inject(_presence_payload(games, keys, 1))
        await engine.flush()
        arena = engine.arena_for("PresenceGrain")
        gen0 = arena.generation
        hot_inj = engine.make_injector("PresenceGrain", "heartbeat",
                                       keys[:hot])
        for _ in range(34):
            hot_inj.inject(_presence_payload(games, keys[:hot],
                                             engine.tick_number))
            engine.run_tick()
        await engine.flush()
        # the first sweep compacted mid-drain (dropping its remaining
        # victim ids); a later sweep evicted the rest
        assert arena.generation > gen0
        assert engine.collector.victims_dropped_stale > 0
        assert arena.live_count == hot

    _twin(run, go, type_names=("PresenceGrain", "GameGrain"),
          store="memory", initial_capacity=512, auto_fusion_ticks=0,
          collection_idle_ticks=16, collection_every_ticks=8,
          collection_pause_budget_s=0.0, collection_chunk_rows=32)


def test_stats_keys_match_jax(run, jax_trace_shim):
    """``stats()`` carries the JAX engine's collection, timers and
    tick-stage keys (``snapshot()["collection"]``, ``["timers"]`` and
    ``["last_tick_stages"]``)."""
    j, p = _twin(run, lambda s: _presence_collection(s, 300, 30),
                 type_names=("PresenceGrain", "GameGrain"), store="memory",
                 initial_capacity=512, auto_fusion_ticks=0,
                 collection_idle_ticks=24, collection_every_ticks=8,
                 collection_pause_budget_s=0.0, collection_chunk_rows=64,
                 compact_fragmentation_threshold=0.0)
    js, ps = j.engine.snapshot(), p.engine.stats()
    for key in ("collection", "timers"):
        assert set(ps[key]) == set(js[key]), key
    for key in ("evicted", "restored"):
        assert ps[key] == js[key], key
    assert ps["fragmentation"] == js["fragmentation"]
    assert set(ps["last_tick_stages"]) == set(js["last_tick_stages"])
