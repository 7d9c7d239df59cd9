"""Differential tests of the port's hot-grain replicas against the JAX
package, at one shard block.

K18 ``spread_replicas`` (its plain version here) against the JAX
``_spread_replicas_kernel`` and the JAX arena's host twin
``spread_rows_host`` on the same mirror; then engine twins of
tests/test_replication.py: each scenario runs on a JAX engine at
``n_shards = 1`` and on a port engine on ``device="cpu"``, from the same
numpy draws, and the two arenas are compared row for row — the key→row
map, the replica groups and their secondary mask, the free list, every
state column, both use clocks, the counters — besides the scenario's own
checks against an unreplicated oracle.  Integer columns must be equal;
a float32 column within ``2 * n * 2**-24 * sum|x|`` of its oracle, ``n``
the number of terms (the routing sums use integer-valued floats and come
out exact as well).

The controller case (runtime/rebalancer.py) and the kill/recover case
(the replica group in a checkpoint cut) of tests/test_replication.py
wait for the port's host integration and durability slices.

The installed JAX lacks ``jax.core.trace_state_clean``, which the JAX
attribution plane's flush calls (a demote retires the secondaries'
counts through it): the ``jax_trace_shim`` fixture sets it per test.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.routing as jax_routing
import tests.test_replication  # noqa: F401 — registers JAX ReplCounter
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import MemoryVectorStore as JaxMemoryVectorStore
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor.arena import _spread_replicas_kernel

from orleans_tpu_torch.config import TensorEngineConfig
from orleans_tpu_torch.convert import arena_state_from_numpy
from orleans_tpu_torch.core.grain import batched_method, commutative
from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.replicas import (
    spread_replicas,
    spread_replicas_plain,
)
from orleans_tpu_torch.samples import routing as port_routing
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor.fused import CAUSE_REPLICA_CHANGE
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    seg_max,
    seg_sum,
    vector_grain,
    vector_type,
)


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


if vector_type("ReplCounter") is None:
    @vector_grain
    class ReplCounter(VectorGrain):
        # a sum fold (the default) and a max fold: both must survive
        # promote and demote exactly
        total = field(torch.int32, 0)
        hwm = field(torch.int32, 0, fold="max")

        @batched_method
        @staticmethod
        @commutative
        def bump(state, batch: Batch, n_rows: int):
            amt = batch.args["amount"]
            return {**state,
                    "total": state["total"]
                    + seg_sum(amt, batch.rows, n_rows),
                    "hwm": torch.maximum(
                        state["hwm"], seg_max(amt, batch.rows, n_rows))}


def _sides(store=None, initial_capacity=1024, **cfg):
    """The JAX side and the port side of one scenario, at one shard
    block, auto-fusion off unless ``cfg`` says otherwise."""
    cfg.setdefault("auto_fusion_ticks", 0)
    jstore, pstore = (JaxMemoryVectorStore(), MemoryVectorStore()) \
        if store else (None, None)
    j = types.SimpleNamespace(
        engine=JaxTensorEngine(config=JaxEngineConfig(**cfg), store=jstore,
                               initial_capacity=initial_capacity),
        store=jstore, dev=lambda a: jnp.asarray(a))
    p = types.SimpleNamespace(
        engine=TensorEngine(config=TensorEngineConfig(**cfg), store=pstore,
                            initial_capacity=initial_capacity,
                            device="cpu"),
        store=pstore, dev=lambda a: torch.from_numpy(np.array(a)))
    return j, p


def _bump(s, keys, amounts):
    s.engine.send_batch("ReplCounter", "bump",
                        np.asarray(keys, dtype=np.int64),
                        {"amount": np.asarray(amounts, np.int32)})


def _folds(engine, keys, col, type_name="ReplCounter") -> np.ndarray:
    """Observable state per key: ``read_row`` folds a live group."""
    arena = engine.arena_for(type_name)
    return np.array([arena.read_row(int(k))[col] for k in keys])


def _assert_arena_twins(ja, pa):
    assert ja.n_shards == 1
    assert pa.capacity == ja.capacity
    np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
    np.testing.assert_array_equal(pa._free[0], ja._free[0])
    np.testing.assert_array_equal(pa._shard_next, ja._shard_next)
    assert sorted(pa._replicas) == sorted(ja._replicas)
    for k, rws in ja._replicas.items():
        np.testing.assert_array_equal(pa._replicas[k], rws)
    np.testing.assert_array_equal(pa._replica_secondary,
                                  ja._replica_secondary)
    for attr in ("live_count", "evicted_count", "restored_count",
                 "eviction_epoch", "generation", "replica_promotions",
                 "replica_demotions", "replica_folds"):
        assert getattr(pa, attr) == getattr(ja, attr), attr
    for name, col in ja.state.items():
        np.testing.assert_array_equal(pa.state[name].numpy(),
                                      np.asarray(col), err_msg=name)
    np.testing.assert_array_equal(pa.last_use_dev.numpy(),
                                  np.asarray(ja.last_use_dev))
    live = np.flatnonzero(ja._key_of_row >= 0)
    np.testing.assert_array_equal(pa.last_use(live), ja.last_use_tick[live])
    np.testing.assert_array_equal(np.sort(pa.keys()), np.sort(ja.keys()))


def _assert_twins(j, p, type_names=("ReplCounter",)):
    je, pe = j.engine, p.engine
    for t in type_names:
        _assert_arena_twins(je.arena_for(t), pe.arena_for(t))
        if je.attribution.has_state(t):
            assert pe.attribution.per_key_totals(t) == \
                je.attribution.per_key_totals(t), t
    for attr in ("tick_number", "messages_processed", "activation_passes",
                 "replications", "grains_replicated", "replica_demotions"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    js, ps = je.snapshot(), pe.stats()
    for k in ("replications", "grains_replicated", "replica_demotions",
              "replica_folds", "replicated_now"):
        assert ps[k] == js[k], k


def _twin(run, scenario, type_names=("ReplCounter",), **kw):
    j, p = _sides(**kw)
    run(scenario(j))
    run(scenario(p))
    _assert_twins(j, p, type_names)
    return j, p


# -- K18 ------------------------------------------------------------------

@pytest.mark.parametrize("n_groups", [1, 3, 9])
def test_spread_matches_jax_kernel_and_host_twin(run, n_groups,
                                                 jax_trace_shim):
    """K18 (plain) equals JAX ``_spread_replicas_kernel`` and both host
    twins on the same mirror: groups of k = 2..8 rows (9 groups pad the
    mirror to 16), tiled lookups of every key, -1 lanes, 5,000 lanes;
    the lane hash wraps uint32 from lane 2 on."""
    rng = np.random.default_rng(100 + n_groups)
    keys = np.arange(64, dtype=np.int64)
    hot = rng.choice(64, n_groups, replace=False)
    ks = [2 + i % 7 for i in range(n_groups)]

    async def go(s):
        _bump(s, keys, np.ones(64, np.int32))
        await s.engine.flush()
        for key, k in zip(hot.tolist(), ks):
            assert s.engine.replicate_key("ReplCounter", key, k) == k

    j, p = _twin(run, go)
    ja, pa = j.engine.arena_for("ReplCounter"), p.engine.arena_for(
        "ReplCounter")
    for a, b in zip(pa._replica_mirror_host(), ja._replica_mirror_host()):
        np.testing.assert_array_equal(a, b)
    rows, found = ja.lookup_rows(rng.choice(keys, 5000))
    assert found.all()
    rows = rows.astype(np.int32)
    rows[rng.random(5000) < 0.1] = -1
    want = np.asarray(_spread_replicas_kernel(*ja.replica_mirror(),
                                              jnp.asarray(rows)))
    np.testing.assert_array_equal(ja.spread_rows_host(rows), want)
    np.testing.assert_array_equal(pa.spread_rows_host(rows), want)
    mirror = pa.replica_mirror()
    got = spread_replicas(*mirror, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        spread_replicas_plain(*mirror, torch.from_numpy(rows)).numpy(),
        want)
    # the spread fans out over each group and nowhere else
    for key in hot.tolist():
        grp = ja._replicas[int(key)]
        hit = want[rows == grp[0]]
        assert set(hit.tolist()) <= set(grp.tolist())
        assert len(set(hit.tolist())) > 1
    plain_lanes = ~np.isin(rows, [g[0] for g in ja._replicas.values()])
    np.testing.assert_array_equal(want[plain_lanes], rows[plain_lanes])


def test_spread_on_the_cpu_never_counts_a_launch():
    _build.reset_launch_counts()
    prim = torch.tensor([3, 2**31 - 1], dtype=torch.int32)
    counts = torch.tensor([2, 1], dtype=torch.int32)
    table = torch.full((2, 8), -1, dtype=torch.int32)
    table[0, :2] = torch.tensor([3, 9])
    out = spread_replicas(prim, counts, table,
                          torch.tensor([3, 3, 3, -1, 5], dtype=torch.int32))
    assert out.tolist() == [3, 9, 9, -1, 5]
    assert _build.launch_counts()["spread_replicas"] == 0


# -- twins of tests/test_replication.py ------------------------------------

def test_replication_exactness_vs_unreplicated_oracle(run, jax_trace_shim):
    """Promote a hot key to 3 rows at tick 3, demote it at tick 8: per-row
    state equal to JAX's throughout, folds (sum and max) equal to an
    engine that never replicates, mid-promotion too."""
    keys = np.arange(128, dtype=np.int64)
    hot = 5
    rng = np.random.default_rng(23)
    plan = [(rng.integers(1, 100, 128).astype(np.int32),
             rng.integers(1, 100, 64).astype(np.int32)) for _ in range(12)]
    mid = {}

    def scenario(oracle: bool):
        async def go(s):
            for t, (amounts, extra) in enumerate(plan):
                _bump(s, keys, amounts)
                # the hot wave the spread partitions over the group
                _bump(s, np.full(64, hot), extra)
                s.engine.run_tick()
                if t == 3 and not oracle:
                    assert s.engine.replicate_key("ReplCounter", hot, 3) == 3
                if t == 5:
                    await s.engine.flush()
                    mid[(id(s), "total")] = _folds(s.engine, keys, "total")
                    mid[(id(s), "hwm")] = _folds(s.engine, keys, "hwm")
                if t == 8 and not oracle:
                    assert s.engine.demote_key("ReplCounter", hot) == 2
            await s.engine.flush()
        return go

    j, p = _sides()
    run(scenario(False)(j))
    run(scenario(False)(p))
    _assert_twins(j, p)
    o = types.SimpleNamespace(engine=TensorEngine(
        config=TensorEngineConfig(auto_fusion_ticks=0), device="cpu"))
    run(scenario(True)(o))
    for col in ("total", "hwm"):
        for s in (j, p):
            np.testing.assert_array_equal(mid[(id(s), col)],
                                          mid[(id(o), col)])
            np.testing.assert_array_equal(_folds(s.engine, keys, col),
                                          _folds(o.engine, keys, col))
    arena = p.engine.arena_for("ReplCounter")
    assert not arena._replicas and arena.replica_folds >= 1
    stats = p.engine.stats()
    assert stats["replications"] == 1 and stats["replica_demotions"] == 1
    assert stats["replicated_now"] == 0


def test_promote_demote_identity_discipline(run, jax_trace_shim):
    """Promote is idempotent, secondaries stay out of ``keys()`` and
    ``live_count``, a demote of an unreplicated key does nothing, and an
    eviction of a promoted key demotes first."""
    keys = np.arange(32, dtype=np.int64)

    async def go(s):
        engine = s.engine
        _bump(s, keys, np.full(32, 7))
        engine.run_tick()
        await engine.flush()
        arena = engine.arena_for("ReplCounter")
        live0 = arena.live_count
        assert engine.replicate_key("ReplCounter", 9, 3) == 3
        assert engine.replicate_key("ReplCounter", 9, 3) == 3
        assert engine.replications == 1
        assert arena.live_count == live0
        assert set(arena.keys().tolist()) == set(keys.tolist())
        assert engine.demote_key("ReplCounter", 10) == 0
        assert engine.replica_demotions == 0
        _bump(s, keys, np.full(32, 3))
        engine.run_tick()
        await engine.flush()
        assert int(arena.read_row(9)["total"]) == 10
        arena.evict_keys(np.array([9], dtype=np.int64), write_back=False)
        assert not arena._replicas
        _, found = arena.lookup_rows(np.array([9], dtype=np.int64))
        assert not found[0]

    _twin(run, go)


def test_collection_skips_members_and_eviction_writes_the_fold(
        run, jax_trace_shim):
    """An idle sweep never takes a replica member (demotion is its only
    exit); evicting the promoted key writes the merged state to the store,
    and the next message re-activates it from there."""
    keys = np.arange(16, dtype=np.int64)
    rng = np.random.default_rng(5)
    waves = [rng.integers(1, 50, 40).astype(np.int32) for _ in range(3)]

    async def go(s):
        engine = s.engine
        arena = engine.arena_for("ReplCounter")
        arena.compact_fragmentation = 0.0
        _bump(s, keys, np.full(16, 2))
        await engine.flush()
        assert engine.replicate_key("ReplCounter", 3, 4) == 4
        for w in waves:
            _bump(s, np.full(40, 3), w)
            await engine.flush()
        engine.tick_number += 100
        # the group is idle too, but only the other 15 keys go
        assert engine.collect_idle(max_idle_ticks=50) == 15
        assert len(arena._replicas) == 1
        assert arena.evict_keys(np.array([3], dtype=np.int64)) == 1
        rec = s.store.read_many("ReplCounter", [3])[3]
        assert int(rec["total"]) == 2 + sum(int(w.sum()) for w in waves)
        assert int(rec["hwm"]) == max(int(w.max()) for w in waves)
        _bump(s, [3], [1])
        await engine.flush()
        assert int(arena.read_row(3)["total"]) == int(rec["total"]) + 1

    j, p = _twin(run, go, store=True)
    for k in j.store.list_keys("ReplCounter").tolist():
        jr = j.store.read_many("ReplCounter", [k])[k]
        pr = p.store.read_many("ReplCounter", [k])[k]
        for f, v in jr.items():
            np.testing.assert_array_equal(pr[f], v)


def test_growth_and_compaction_with_a_live_group(run, jax_trace_shim):
    """A live group rides a growth (rows keep their index at one block)
    and a threshold compaction (rows move, the group is remapped): the
    per-row state and the folds stay equal to JAX's."""
    rng = np.random.default_rng(11)
    amounts = [rng.integers(1, 9, 48).astype(np.int32) for _ in range(4)]

    async def go(s):
        engine = s.engine
        arena = engine.arena_for("ReplCounter")
        arena.compact_fragmentation = 0.5
        _bump(s, np.arange(24), np.ones(24, np.int32))
        await engine.flush()
        assert engine.replicate_key("ReplCounter", 20, 5) == 5
        _bump(s, np.full(48, 20), amounts[0])
        await engine.flush()
        gen0 = arena.generation
        _bump(s, np.arange(100, 160), np.full(60, 2))  # grows past 32 rows
        await engine.flush()
        assert arena.capacity > 32 and arena.generation > gen0
        _bump(s, np.full(48, 20), amounts[1])
        await engine.flush()
        engine.tick_number += 100
        arena.resolve_rows(np.array([20], dtype=np.int64),
                           tick=engine.tick_number)
        gen1 = arena.generation
        # 83 of 84 keys idle: the sweep crosses the threshold and repacks
        assert engine.collect_idle(50, write_back=False) == 83
        assert arena.generation > gen1 and arena.fragmentation() == 0.0
        _bump(s, np.full(48, 20), amounts[2])
        await engine.flush()
        want = 1 + sum(int(a.sum()) for a in amounts[:3])
        assert int(arena.read_row(20)["total"]) == want
        assert engine.demote_key("ReplCounter", 20) == 4
        _bump(s, np.full(48, 20), amounts[3])
        await engine.flush()
        assert int(arena.read_row(20)["total"]) == want + int(
            amounts[3].sum())

    _twin(run, go, initial_capacity=32)


def test_attribution_across_promote_and_demote(run, jax_trace_shim):
    """The plane counts a replicated grain's traffic on every row of its
    group; ``per_key_totals`` merges them under the key, and a demote
    retires the secondaries' counts under it, so totals survive; the hot
    set names the same grains with the same counts as JAX's."""
    keys = np.arange(40, dtype=np.int64)

    async def go(s):
        engine = s.engine
        for t in range(6):
            _bump(s, keys, np.ones(40, np.int32))
            _bump(s, np.full(30, 7), np.full(30, 2))
            _bump(s, np.full(10, 11), np.ones(10, np.int32))
            engine.run_tick()
            if t == 1:
                assert engine.replicate_key("ReplCounter", 7, 4) == 4
            if t == 4:
                assert engine.demote_key("ReplCounter", 7) == 3
        await engine.flush()
        totals = engine.attribution.per_key_totals("ReplCounter")
        assert totals[7] == 6 * 31 and totals[11] == 6 * 11

    j, p = _twin(run, go)
    jh, ph = j.engine.attribution.hot_set(), p.engine.attribution.hot_set()
    assert [(h["arena"], h["key"], h["msgs"]) for h in ph] == \
        [(h["arena"], h["key"], h["msgs"]) for h in jh]


# -- the routing sample ----------------------------------------------------

N_SRC, N_SINK = 600, 16


def _routing_inputs(hot: bool):
    sources = np.arange(N_SRC, dtype=np.int64)
    sinks = jax_routing.sink_keys(N_SINK)
    dst = np.full(N_SRC, int(sinks[0]), np.int64) if hot else \
        port_routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                              seed=3)
    values = np.random.default_rng(4).integers(1, 8, N_SRC).astype(
        np.float32)
    return sources, sinks, dst, values


def _sink_state(engine, sinks):
    return (_folds(engine, sinks, "received", "RouteSink").astype(np.int64),
            _folds(engine, sinks, "total", "RouteSink").astype(np.float64))


def _assert_sink_oracle(engine, sources, sinks, dst, values, n_ticks):
    want_total, want_recv = port_routing.expected_sink_state(
        sources, dst, values, sinks, n_ticks)
    recv, total = _sink_state(engine, sinks)
    np.testing.assert_array_equal(recv, want_recv)
    # Higham's bound over the n terms summed into each sink
    bound = 2 * want_recv * 2.0**-24 * want_total
    assert np.all(np.abs(total - want_total) <= bound)


def test_routing_loader_matches_jax_and_expected_state(run,
                                                       jax_trace_shim):
    """``run_routing_load`` (uniform, ratio 0 on one block) against the
    JAX loader and ``expected_sink_state``: the same destinations, the
    same per-row sink state, the same stats keys."""
    j, p = _sides(initial_capacity=64)
    js = run(jax_routing.run_routing_load(j.engine, N_SRC, N_SINK, 0.0,
                                          n_ticks=3, seed=3))
    ps = run(port_routing.run_routing_load(p.engine, N_SRC, N_SINK, 0.0,
                                           n_ticks=3, seed=3))
    assert set(ps) == set(js)
    for k in ("sources", "sinks", "cross_ratio", "ticks", "total_ticks",
              "messages", "engine", "bucket_utilization",
              "exchange_overlap_s", "exchange_caps"):
        assert ps[k] == js[k], k
    _assert_twins(j, p, ("RouteSource", "RouteSink"))
    sources, sinks, _, _ = _routing_inputs(False)
    dst = jax_routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                               seed=3)
    np.testing.assert_array_equal(
        port_routing.build_ratio_destinations(sources, sinks, 1, 0.0,
                                              seed=3), dst)
    values = np.random.default_rng(4).integers(1, 8, N_SRC).astype(
        np.float32)
    _assert_sink_oracle(p.engine, sources, sinks, dst, values,
                        ps["total_ticks"])


@pytest.mark.parametrize("k", [2, 8])
def test_hot_sink_unfused_replicated_matches_jax(run, k, jax_trace_shim):
    """Every source sends to one sink: unreplicated for 2 ticks, then the
    sink promoted to k rows for 3, then demoted for 1.  The per-row state
    of both arenas equals JAX's after every phase (the spread assigns the
    same lanes to the same replica rows), the fold equals
    ``expected_sink_state``, and after the demote the sink's one row holds
    it."""
    sources, sinks, dst, values = _routing_inputs(True)
    hot = int(sinks[0])

    def scenario(s, phase):
        async def go():
            eng = s.engine
            if phase == 0:
                eng.arena_for("RouteSource").reserve(N_SRC)
                eng.arena_for("RouteSink").reserve(N_SINK)
                eng.arena_for("RouteSource").resolve_rows(sources)
                eng.arena_for("RouteSink").resolve_rows(sinks)
                s.inj = eng.make_injector("RouteSource", "send", sources)
            n = {0: 2, 1: 3, 2: 1}[phase]
            if phase == 1:
                assert eng.replicate_key("RouteSink", hot, k) == k
            if phase == 2:
                assert eng.demote_key("RouteSink", hot) == k - 1
            for _ in range(n):
                s.inj.inject({"dst": s.dev(dst.astype(np.int32)),
                              "v": s.dev(values)})
                await eng.drain_queues()
            await eng.flush()
        return go()

    j, p = _sides(initial_capacity=64)
    done = 0
    for phase, n in enumerate((2, 3, 1)):
        run(scenario(j, phase))
        run(scenario(p, phase))
        done += n
        _assert_twins(j, p, ("RouteSource", "RouteSink"))
        _assert_sink_oracle(p.engine, sources, sinks, dst, values, done)
        if phase == 1:
            grp = p.engine.arena_for("RouteSink")._replicas[hot]
            recv = p.engine.arena_for("RouteSink").state["received"]
            assert bool((recv[torch.from_numpy(grp)] > 0).all())
    row = int(p.engine.arena_for("RouteSink").lookup_rows(
        np.array([hot]))[0][0])
    recv, _ = _sink_state(p.engine, sinks)
    assert int(p.engine.arena_for("RouteSink").state["received"][row]) \
        == recv[0] == N_SRC * done


def test_fused_window_over_replicated_sink_matches_unfused_jax(
        run, jax_trace_shim):
    """The port's fused window over a RouteSink promoted to 8 rows equals
    the unfused JAX run tick for tick, per row; a promote and a demote
    between windows each rebuild the window (cause ``replica_change``),
    and the windows after them spread over the new table."""
    sources, sinks, dst, values = _routing_inputs(True)
    hot = int(sinks[0])
    window = 4
    j, p = _sides(initial_capacity=64)
    for s in (j, p):
        s.engine.arena_for("RouteSource").reserve(N_SRC)
        s.engine.arena_for("RouteSink").reserve(N_SINK)
        s.engine.arena_for("RouteSource").resolve_rows(sources)
        s.engine.arena_for("RouteSink").resolve_rows(sinks)
    jinj = j.engine.make_injector("RouteSource", "send", sources)
    prog = p.engine.fuse_ticks("RouteSource", "send", sources)
    static = {"dst": torch.from_numpy(dst.astype(np.int32)),
              "v": torch.from_numpy(values)}
    jargs = {"dst": jnp.asarray(dst.astype(np.int32)),
             "v": jnp.asarray(values)}

    async def jax_ticks(n):
        for _ in range(n):
            jinj.inject(jargs)
            await j.engine.drain_queues()
        await j.engine.flush()

    def both_promote():
        for s in (j, p):
            assert s.engine.replicate_key("RouteSink", hot, 8) == 8

    def both_demote():
        for s in (j, p):
            assert s.engine.demote_key("RouteSink", hot) == 7

    both_promote()
    plan = [None, both_demote, both_promote]
    for change in plan:
        if change is not None:
            change()
        prog.run({"tick": torch.arange(window, dtype=torch.int32)},
                 static_args=static)
        assert prog.verify() == 0
        run(jax_ticks(window))
        for t in ("RouteSource", "RouteSink"):
            ja, pa = j.engine.arena_for(t), p.engine.arena_for(t)
            np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
            for name, col in ja.state.items():
                np.testing.assert_array_equal(pa.state[name].numpy(),
                                              np.asarray(col), err_msg=name)
    assert prog.rebuilds[CAUSE_REPLICA_CHANGE] == 2
    assert prog.rebuilds["new_window"] == 1
    _assert_sink_oracle(p.engine, sources, sinks, dst, values,
                        window * len(plan))


def test_convert_carries_replica_groups(run, jax_trace_shim):
    """A port arena loaded from a promoted JAX arena (``arena_state_from_
    numpy`` with its groups) spreads the next tick exactly as JAX does."""
    keys = np.arange(20, dtype=np.int64)
    j, p = _sides(initial_capacity=32)

    async def warm():
        _bump(j, keys, np.full(20, 3))
        await j.engine.flush()
        assert j.engine.replicate_key("ReplCounter", 4, 6) == 6
        _bump(j, np.full(30, 4), np.arange(30, dtype=np.int32))
        await j.engine.flush()

    run(warm())
    ja = j.engine.arena_for("ReplCounter")
    pa = p.engine.arena_for("ReplCounter")
    arena_state_from_numpy(
        pa, ja._key_of_row, {n: np.asarray(c) for n, c in ja.state.items()},
        free_rows=ja._free[0], shard_next=int(ja._shard_next[0]),
        last_use_tick=ja.last_use_tick,
        last_use_dev=np.asarray(ja.last_use_dev),
        eviction_epoch=ja.eviction_epoch, replicas=ja._replicas,
        replica_counts=(ja.replica_promotions, ja.replica_demotions,
                        ja.replica_folds))
    assert pa.live_count == ja.live_count
    assert sorted(pa.keys().tolist()) == sorted(ja.keys().tolist())

    async def more(s):
        _bump(s, np.full(30, 4), np.arange(30, 60, dtype=np.int32))
        await s.engine.flush()

    run(more(j))
    run(more(p))
    for name, col in ja.state.items():
        np.testing.assert_array_equal(pa.state[name].numpy(),
                                      np.asarray(col), err_msg=name)
    assert int(pa.read_row(4)["total"]) == int(ja.read_row(4)["total"])
