"""Differential tests of the port's shard blocks and cross-shard exchange
against the JAX package, at 8 blocks.

The JAX side runs on the conftest's 8-device virtual CPU mesh with
``exchange_structured="always"`` (as tests/test_cross_shard.py pins it);
the port side on a ``ShardMesh`` of 8 blocks on the CPU, where K23 and K24
take their plain versions.  Inputs come from numpy seeds and go to both.
Everything compared is integer or an integer-valued float32 sum, so every
comparison is exact:

* ``ShardExchange.dispatch`` — rows, every payload leaf (4-byte, 2-D and a
  scalar), mask, dropped lanes and stats — for legacy caps 0, fitting and
  overflowing, the fallback plan, per-destination caps with send and
  receive overflow, and a batch whose lanes do not divide by 8; the
  disengaged probe's stats;
* the plan ladder and the demand estimator (twins of test_cross_shard.py
  :103 and :661);
* the routing load (samples/routing.py) at 4,096 sources / 1,024 sinks,
  ratios 0, 0.5 and 0.9, unfused and in fused windows of 4: sink state and
  the exchange's counters against the JAX engine and
  ``expected_sink_state``;
* overflow lanes delivered again with their original inject stamp, the
  ledger histograms equal (twin of :195); "auto" disengaging on the
  one-card mesh and probing (twin of :891); the rows of an arena of 8
  blocks, row for row, across growth, eviction and compaction.

The card's own checks of K23 and K24 against their plain versions are in
tests/test_torch_cuda.py (marked ``cuda``).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import samples.routing as jax_routing
from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.kernels import exchange as kx
from orleans_tpu_torch.samples import routing as port_routing
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor.exchange import ladder_ceil, pow2ceil
from orleans_tpu_torch.tensor.fused import (
    CAUSE_BUCKET_GROWTH,
    CAUSE_CONFIG_TOGGLE,
)
from orleans_tpu_torch.tensor.mesh import ShardMesh

N = 8
SITE = ("RouteSink", "recv")


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _jax_engine(n=N, **cfg) -> JaxTensorEngine:
    """A JAX engine on the virtual mesh; the attribution plane off (its
    folds are not what these cases compare, and each is a JAX program to
    compile)."""
    cfg.setdefault("auto_fusion_ticks", 0)
    cfg.setdefault("exchange_structured", "always")
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("grains",))
    return JaxTensorEngine(mesh=mesh, initial_capacity=1024,
                           config=JaxEngineConfig(**cfg),
                           metrics=JaxMetricsConfig(attribution_enabled=False))


def _port_engine(n=N, **cfg) -> TensorEngine:
    cfg.setdefault("auto_fusion_ticks", 0)
    cfg.setdefault("exchange_structured", "always")
    return TensorEngine(mesh=ShardMesh(n, "cpu"), device="cpu",
                        initial_capacity=1024,
                        config=TensorEngineConfig(**cfg),
                        metrics=MetricsConfig(attribution_enabled=False))


def _sink_state(engine, n_sinks, port):
    arena = engine.arena_for("RouteSink")
    rows, found = arena.lookup_rows(jax_routing.sink_keys(n_sinks))
    assert found.all()
    if port:
        idx = torch.from_numpy(rows.astype(np.int64))
        return (arena.state["total"][idx].numpy(),
                arena.state["received"][idx].numpy())
    return (np.asarray(arena.state["total"])[rows],
            np.asarray(arena.state["received"])[rows])


# -- dispatch and probe ------------------------------------------------------

# (case, lanes, per_dest mode, observed need (max half) or None, inbound)
DISPATCH_CASES = [
    ("fallback", 1000, "never", None, None),
    ("cap0", 1000, "never", [0] * N, None),
    ("fitting", 1000, "never", [200] * N, None),
    ("overflowing", 1000, "never", [6] * N, None),
    ("ragged", 997, "never", [9] * N, None),
    ("perdest", 1000, "always", [8, 3, 12, 8, 1, 8, 20, 8], [10] * N),
]


def _dispatch_inputs(m, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1024, m).astype(np.int32)
    rows[rng.random(m) < 0.05] = -1
    mask = rng.random(m) < 0.93
    v = rng.integers(1, 9, m).astype(np.float32)
    c = rng.integers(-2**30, 2**30, m).astype(np.int32)
    w = rng.standard_normal((m, 3)).astype(np.float32)
    return rows, mask, v, c, w


@pytest.mark.parametrize("case,m,per_dest,need,inbound", DISPATCH_CASES,
                         ids=[c[0] for c in DISPATCH_CASES])
def test_dispatch_equals_jax(case, m, per_dest, need, inbound):
    rows, mask, v, c, w = _dispatch_inputs(m, seed=len(case) * 7 + m)
    je = _jax_engine(exchange_per_dest=per_dest)
    pe = _port_engine(exchange_per_dest=per_dest)
    ja, pa = je.arena_for("RouteSink"), pe.arena_for("RouteSink")
    assert ja.shard_capacity == pa.shard_capacity == 1024 // N
    site = None
    if need is not None:
        site = SITE
        for e in (je, pe):
            e.exchange.observe_need(
                site, np.asarray(need),
                None if inbound is None else np.asarray(inbound))
        assert pe.exchange.plan_ex(m, site) == je.exchange.plan_ex(m, site)
    # the JAX legacy body's all_to_all reshape takes 1-D leaves only, so
    # the 2-D leaf rides the cases that do not reach it
    two_d = case in ("cap0", "perdest")
    jargs = {"v": jnp.asarray(v), "c": jnp.asarray(c), "t": np.float32(3.0)}
    pargs = {"v": torch.from_numpy(v), "c": torch.from_numpy(c),
             "t": np.float32(3.0)}
    if two_d:
        jargs["w"], pargs["w"] = jnp.asarray(w), torch.from_numpy(w)
    jout = je.exchange.dispatch(ja, jnp.asarray(rows), jargs,
                                jnp.asarray(mask), site=site)
    pout = pe.exchange.dispatch(pa, torch.from_numpy(rows), pargs,
                                torch.from_numpy(mask), site=site)
    (jr, ja2, jm, jd, js), (pr, pa2, pm, pd, ps) = jout, pout
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for k in ("v", "c", "w") if two_d else ("v", "c"):
        np.testing.assert_array_equal(pa2[k].numpy(), np.asarray(ja2[k]),
                                      err_msg=k)
    assert pa2["t"] == np.float32(3.0)
    # the case exercises what it names
    dropped = int(np.asarray(js)[1])
    if case in ("overflowing", "ragged", "perdest", "cap0"):
        assert dropped > 0
    if case in ("fitting", "fallback"):
        assert dropped == 0
    assert pe.exchange.snapshot()["exchanges_run"] == 1
    # the probe (K23) on the same lanes
    np.testing.assert_array_equal(
        pe.exchange._probe(pa, torch.from_numpy(rows),
                           torch.from_numpy(mask), SITE).numpy(),
        np.asarray(je.exchange._probe(ja, jnp.asarray(rows),
                                      jnp.asarray(mask), SITE)))


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors K23 and K24 are their plain versions (nothing
    launches); a 2-D int64 leaf moves through the legacy layout too."""
    rows, mask, v, _c, _w = _dispatch_inputs(1000, seed=3)
    r, m = torch.from_numpy(rows), torch.from_numpy(mask)
    wide = torch.from_numpy(np.arange(2000, dtype=np.int64).reshape(1000, 2))
    before = (kx.exchange_buckets.launches, kx.exchange_classify.launches)
    got = kx.exchange_buckets(r, m, [wide], 128, 128, N, cap=16)
    want = kx.exchange_buckets_plain(r, m, [wide], 128, 128, N, cap=16)
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert torch.equal(a, b)
    assert torch.equal(got[1][0], want[1][0])
    assert torch.equal(kx.exchange_classify(r, m, 128, 128, N),
                       kx.exchange_classify_plain(r, m, 128, 128, N))
    assert (kx.exchange_buckets.launches,
            kx.exchange_classify.launches) == before


# -- planning ----------------------------------------------------------------

def test_plan_ladder_and_estimator_equal_jax():
    """Twins of test_cross_shard.py's plan and estimator cases: the same
    observations give the same plans, grants and versions."""
    je, pe = _jax_engine(), _port_engine()
    jx, px = je.exchange, pe.exchange
    for m in (1, 100, 4096, 100_000):
        assert px.plan(m) == jx.plan(m)
        L, cap = px.plan(m)
        assert L == ladder_ceil(-(-m // N)) and cap == pow2ceil(cap) <= L
    assert px.plan(8 * 544)[0] == ladder_ceil(544) != 544
    for x in (jx, px):
        x.note_transport_width(8 * 544)
    assert px.plan(8 * 544) == jx.plan(8 * 544) == (544, 256)
    for e in (je, pe):
        e.config.exchange_headroom = 1.5
        e.config.exchange_shrink_patience = 3
    steps = [[40, 3] + [0] * 6, [20] + [0] * 7, [200] + [0] * 7,
             [10] + [0] * 7, [10] + [0] * 7, [10] + [0] * 7, [0] * 8]
    for need in steps:
        for x in (jx, px):
            x.observe_need(SITE, np.asarray(need))
        assert px.grant_for(SITE) == jx.grant_for(SITE)
        assert px.cap_version == jx.cap_version
        for m in (8, 4096):
            assert px.plan(m, site=SITE) == jx.plan(m, site=SITE)
    assert px.cap_gauges() == jx.cap_gauges()
    assert px.snapshot()["sites"] == jx.snapshot()["sites"]
    assert px.plan_signature([SITE])[1:] == jx.plan_signature([SITE])[1:]
    for e in (je, pe):
        e.config.exchange_occupancy_sizing = False
    assert px.plan(4096, site=SITE) == jx.plan(4096, site=SITE)


# -- the routing load ----------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("fused", [0, 4])
def test_routing_load_equals_jax(ratio, fused):
    n_src, n_sink = 4096, 1024
    je, pe = _jax_engine(), _port_engine()
    jst = asyncio.run(jax_routing.run_routing_load(
        je, n_src, n_sink, ratio, n_ticks=4, fused_window=fused))
    pst = asyncio.run(port_routing.run_routing_load(
        pe, n_src, n_sink, ratio, n_ticks=4, fused_window=fused))
    assert pst["total_ticks"] == jst["total_ticks"]
    jt, jr = _sink_state(je, n_sink, port=False)
    pt, pr = _sink_state(pe, n_sink, port=True)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pt, jt)
    src = np.arange(n_src, dtype=np.int64)
    sinks = port_routing.sink_keys(n_sink)
    dst = port_routing.build_ratio_destinations(src, sinks, N, ratio)
    vals = np.random.default_rng(1).integers(1, 8, n_src).astype(np.float32)
    want_t, want_r = port_routing.expected_sink_state(
        src, dst, vals, sinks, pst["total_ticks"])
    np.testing.assert_array_equal(pr, want_r)
    np.testing.assert_array_equal(pt, want_t)
    jx, px = je.snapshot()["exchange"], pe.stats()["exchange"]
    for k in ("exchanges_run", "cross_shard_msgs", "delivered_msgs",
              "dropped_msgs", "redeliveries", "bucket_utilization",
              "cap_version"):
        assert px[k] == jx[k], k
    assert px["sites"] == jx["sites"]
    assert pst["bucket_utilization"] == jst["bucket_utilization"]
    if not fused:
        assert px["exchanges_run"] > 0 and px["dropped_msgs"] == 0
        assert px["delivered_msgs"] == 2 * n_src * pst["total_ticks"]
    else:
        assert px["exchanges_run"] > 0
        assert pe.autofuser is not None  # the window ran through run()


def test_cross_shard_count_matches_constructed_ratio():
    """Twin of test_cross_shard.py:184: the sink leg crosses exactly
    round(ratio * n) lanes a tick (post-exchange every emit lane sits on
    its source's home block); the source leg crosses where the injection
    layout puts a source off its home chunk."""
    n_src, n_sink, ratio, ticks = 512, 256, 0.5, 4
    pe = _port_engine()
    asyncio.run(port_routing.run_routing_load(pe, n_src, n_sink, ratio,
                                              n_ticks=ticks, warm_ticks=0))
    xs = pe.stats()["exchange"]
    src = np.arange(n_src, dtype=np.int64)
    lane_shard = np.arange(n_src) // -(-n_src // N)
    from orleans_tpu_torch.tensor.arena import shard_of_keys
    src_cross = int((shard_of_keys(src, N) != lane_shard).sum())
    assert xs["cross_shard_msgs"] == \
        (src_cross + int(round(ratio * n_src))) * ticks
    assert xs["delivered_msgs"] == 2 * n_src * ticks
    assert xs["dropped_msgs"] == 0


# -- overflow and redelivery ---------------------------------------------------

def test_overflow_redelivers_with_original_stamp():
    """Twin of test_cross_shard.py:195 (at 64 sources): every message to
    one sink under a tiny bucket — lanes overflow, are delivered again
    over later ticks with their original stamp, nothing is lost, and the
    port's ledger histogram equals the JAX engine's."""
    n_src = 64

    async def drive(e, port):
        e.config.exchange_pad_quantum = 2
        e.config.exchange_capacity_factor = 0.25
        src = np.arange(n_src, dtype=np.int64)
        e.arena_for("RouteSource").reserve(n_src)
        e.arena_for("RouteSink").reserve(64)
        e.arena_for("RouteSource").resolve_rows(src)
        e.arena_for("RouteSink").resolve_rows(np.arange(64, dtype=np.int64))
        inj = e.make_injector("RouteSource", "send", src)
        if port:
            dst, v = torch.zeros(n_src, dtype=torch.int32), torch.ones(n_src)
        else:
            dst = jnp.asarray(np.zeros(n_src, np.int32))
            v = jnp.asarray(np.ones(n_src, np.float32))
        for t in range(3):
            inj.inject({"dst": dst, "v": v, "tick": np.int32(t)})
            await e.drain_queues()
        await e.flush()

    je, pe = _jax_engine(), _port_engine()
    asyncio.run(drive(je, False))
    asyncio.run(drive(pe, True))
    jx, px = je.snapshot()["exchange"], pe.stats()["exchange"]
    assert px["dropped_msgs"] > 0 and px["redeliveries"] > 0
    for k in ("cross_shard_msgs", "delivered_msgs", "dropped_msgs",
              "redeliveries", "exchanges_run"):
        assert px[k] == jx[k], k
    assert int(pe.arena_for("RouteSink").read_row(0)["received"]) == \
        3 * n_src
    jl, pl = je.ledger.snapshot(), pe.ledger.snapshot()
    sink = pl["RouteSink.recv"]
    assert sink["total"] == 3 * n_src and sum(sink["counts"][1:]) > 0
    for key, want in jl.items():
        assert pl[key]["counts"] == want["counts"], key


def test_auto_disengages_on_one_card_and_probes():
    """Twin of test_cross_shard.py:891: "auto" on the one-card mesh runs
    no structured exchange, the sampled probe still measures the real
    cross traffic (the same estimate as the JAX virtual mesh's), and the
    state is exact against an exchange-off run."""
    je = _jax_engine(exchange_structured="auto", exchange_probe_interval=2)
    pe = _port_engine(exchange_structured="auto", exchange_probe_interval=2)
    assert not pe.exchange.engaged() and not je.exchange.engaged()
    asyncio.run(jax_routing.run_routing_load(je, 512, 256, 0.5, n_ticks=4))
    asyncio.run(port_routing.run_routing_load(pe, 512, 256, 0.5,
                                              n_ticks=4))
    jx, px = je.snapshot()["exchange"], pe.stats()["exchange"]
    assert px["exchanges_run"] == 0 and px["dropped_msgs"] == 0
    assert px["cross_shard_msgs"] == jx["cross_shard_msgs"] > 0
    assert px["sites"] == jx["sites"]
    off = _port_engine(cross_shard_exchange=False)
    asyncio.run(port_routing.run_routing_load(off, 512, 256, 0.5,
                                              n_ticks=4))
    for a, b in zip(_sink_state(pe, 256, True), _sink_state(off, 256, True)):
        np.testing.assert_array_equal(a, b)


def test_fused_window_rebuilds_on_toggle_and_grant_moves():
    """A live exchange toggle rebuilds the window (config_toggle); the
    first verify folds the measured demand, and the next run rebuilds at
    the sized caps (bucket_growth), then steady windows rebuild no
    more."""
    pe = _port_engine()
    src = np.arange(512, dtype=np.int64)
    sinks = port_routing.sink_keys(256)
    pe.arena_for("RouteSource").resolve_rows(src)
    pe.arena_for("RouteSink").resolve_rows(sinks)
    dst = port_routing.build_ratio_destinations(src, sinks, N, 0.5)
    prog = pe.fuse_ticks("RouteSource", "send", src)
    static = {"dst": torch.from_numpy(dst.astype(np.int32)),
              "v": torch.ones(512)}

    def win(t0):
        return {"tick": torch.arange(2, dtype=torch.int32) + t0}

    prog.run(win(0), static_args=static)
    assert prog.verify() == 0
    prog.run(win(2), static_args=static)
    assert prog.verify() == 0
    assert prog.rebuilds[CAUSE_BUCKET_GROWTH] == 1
    assert prog._align[0] is not None
    assert "RouteSource.send" not in prog._site_keys
    assert "RouteSink.recv" in prog._site_keys
    n0 = sum(prog.rebuilds.values())
    for i in range(3):
        prog.run(win(4 + 2 * i), static_args=static)
    assert prog.verify() == 0 and sum(prog.rebuilds.values()) == n0
    pe.config.cross_shard_exchange = False
    prog.run(win(10), static_args=static)
    assert prog.verify() == 0 and prog._exchange_on is False
    assert prog.rebuilds[CAUSE_CONFIG_TOGGLE] == 1
    received = _sink_state(pe, 256, True)[1]
    assert received.sum() == 512 * 12


# -- the arena's shard blocks --------------------------------------------------

def test_arena_rows_equal_jax_at_8_blocks(jax_trace_shim):
    """Activation in batches (several growths), eviction, free-list reuse
    and a compaction: the port's arena equals the JAX arena row for row —
    the key→row map, each block's bump pointer and free list, occupancy,
    capacity, generation and epoch.  Both engines take the mesh-less form
    (``engine.n_shards = 8`` before the arena exists)."""
    from orleans_tpu.tensor.arena import shard_of_keys as jax_shard_of

    from orleans_tpu_torch.tensor.arena import shard_of_keys

    rng = np.random.default_rng(17)
    je = JaxTensorEngine(initial_capacity=16,
                         config=JaxEngineConfig(auto_fusion_ticks=0))
    pe = TensorEngine(initial_capacity=16, device="cpu",
                      config=TensorEngineConfig(auto_fusion_ticks=0))
    for e in (je, pe):
        e.n_shards = N
    ja, pa = je.arena_for("RouteSink"), pe.arena_for("RouteSink")

    def same():
        assert (pa.capacity, pa.shard_capacity, pa.n_shards) == \
            (ja.capacity, ja.shard_capacity, ja.n_shards)
        np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
        np.testing.assert_array_equal(pa._shard_next, ja._shard_next)
        for f, g in zip(pa._free, ja._free):
            np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(pa.shard_occupancy(),
                                      ja.shard_occupancy())
        assert pa.fragmentation() == ja.fragmentation()
        for attr in ("generation", "eviction_epoch", "live_count"):
            assert getattr(pa, attr) == getattr(ja, attr), attr

    keys = np.unique(rng.integers(0, 2**31 - 2, 300, dtype=np.int64))
    for part in np.array_split(keys, 4):
        for a in (ja, pa):
            a.resolve_rows(part)
        same()
    rows, _ = pa.lookup_rows(keys)
    np.testing.assert_array_equal(rows // pa.shard_capacity,
                                  shard_of_keys(keys, N))
    np.testing.assert_array_equal(shard_of_keys(keys, N),
                                  jax_shard_of(keys, N))
    victims = rng.choice(keys, 60, replace=False)
    for a in (ja, pa):
        a.compact_fragmentation = 0.0  # no repack yet
        a.evict_keys(victims, write_back=False)
    same()
    fresh = np.arange(2**31 - 500, 2**31 - 440, dtype=np.int64)
    for a in (ja, pa):
        a.resolve_rows(fresh)
    same()
    for a in (ja, pa):
        a._compact()
    same()
    assert pa.sharding is None and pe.exchange is None
    # every live row, column by column
    live = np.flatnonzero(ja._key_of_row >= 0)
    np.testing.assert_array_equal(pa.last_use_tick[live],
                                  ja.last_use_tick[live])


def test_autofuse_engages_over_the_exchange():
    """Twin of test_cross_shard.py:386: the steady routing pattern
    engages auto-fusion over the structured exchange, runs exchanged
    windows without a rollback, and stays exact."""
    pe = _port_engine(auto_fusion_ticks=3, auto_fusion_window=4)
    asyncio.run(port_routing.run_routing_load(pe, 256, 128, 0.5,
                                              n_ticks=16, warm_ticks=0))
    assert pe.autofuser.ticks_fused > 0
    assert pe.autofuser.windows_rolled_back == 0
    assert _sink_state(pe, 128, True)[1].sum() == 256 * 16


def test_checkpoint_defers_while_exchange_checks_parked():
    """Twin of test_cross_shard.py:255: a periodic write-back with
    exchange redeliveries still parked defers one tick (the checks drain
    and requeue with their stamp); it lands after they apply."""
    from orleans_tpu_torch.tensor.engine import _ExchangeCheck
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

    pe = TensorEngine(mesh=ShardMesh(N, "cpu"), device="cpu",
                      initial_capacity=64, store=MemoryVectorStore(),
                      config=TensorEngineConfig(auto_fusion_ticks=0,
                                                checkpoint_every_ticks=1))
    sinks = port_routing.sink_keys(8)
    pe.arena_for("RouteSink").resolve_rows(sinks)
    pe.tick_number = 5
    pe._exchange_checks.append(_ExchangeCheck(
        type_name="RouteSink", method="recv",
        keys=torch.from_numpy(sinks[:4].astype(np.int32)),
        args={"v": torch.ones(4), "count": torch.ones(4, dtype=torch.int32)},
        dropped=torch.tensor([True, False, False, False]),
        stats=torch.tensor([1, 1, 3] + [0] * (2 * N), dtype=torch.int32),
        inject_tick=2))
    assert pe.maybe_periodic_checkpoint() == 0.0
    assert not pe._exchange_checks
    redelivery = pe.queues[("RouteSink", "recv")]
    assert redelivery and redelivery[0].inject_tick == 2
    asyncio.run(pe.flush())
    assert pe._last_checkpoint_tick > 0
    assert int(pe.arena_for("RouteSink").read_row(int(sinks[0]))
               ["received"]) == 1


def test_snapshot_store_over_shard_blocks_raises():
    """Recovery points of several blocks belong to the next slice: an
    engine of 8 blocks refuses a snapshot store, and so does an engine
    whose blocks are set before its first arena."""
    from orleans_tpu_torch.tensor.checkpoint import MemorySnapshotStore

    with pytest.raises(NotImplementedError, match="next slice"):
        TensorEngine(mesh=ShardMesh(N, "cpu"), device="cpu",
                     snapshot_store=MemorySnapshotStore())
    e = TensorEngine(device="cpu", snapshot_store=MemorySnapshotStore())
    e.n_shards = N
    with pytest.raises(NotImplementedError, match="next slice"):
        e.arena_for("RouteSink")


def test_multi_batch_groups_exchange_exactly():
    """Two injectors of one (type, method) make a group of two batches
    (and their emits another): the group exchanges as one concatenated
    batch, its overflow lanes redeliver by their own keys, and the sink
    state is exact."""
    pe = _port_engine(exchange_pad_quantum=2, exchange_capacity_factor=0.25)
    src, sinks = np.arange(3000), port_routing.sink_keys(700)
    dst = port_routing.build_ratio_destinations(src, sinks, N, 0.7)
    pe.arena_for("RouteSource").resolve_rows(src)
    pe.arena_for("RouteSink").resolve_rows(sinks)
    parts = [(pe.make_injector("RouteSource", "send", src[a:b]),
              torch.from_numpy(dst[a:b].astype(np.int32)), b - a)
             for a, b in ((0, 1700), (1700, 3000))]
    for t in range(5):
        for inj, d, n in parts:
            inj.inject({"dst": d, "v": torch.ones(n), "tick": np.int32(t)})
        asyncio.run(pe.drain_queues())
    asyncio.run(pe.flush())
    _t, want = port_routing.expected_sink_state(
        src, dst, np.ones(3000, np.float32), sinks, 5)
    np.testing.assert_array_equal(_sink_state(pe, 700, True)[1], want)
    xs = pe.stats()["exchange"]
    assert xs["dropped_msgs"] > 0 and xs["redeliveries"] > 0
    assert xs["delivered_msgs"] == 2 * 3000 * 5
