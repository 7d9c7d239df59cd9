"""Differential tests of the port's follower fan-out (Chirper) against the
JAX package.

A registered ``DeviceFanout`` expands every message its source method
applies through a CSR follow graph into messages for the followers (K11
``fanout_expand``, here its plain version): lanes whose slot range ends
past the expansion width park and expand again at the next drain.  The
same seeded graphs and loads, made with numpy, go through ``orleans_tpu``
(JAX on the CPU) and ``orleans_tpu_torch`` on ``device="cpu"``.  CSRs and
expansions must be equal; arenas are compared by key, integer columns
exactly and the float ``checksum`` within twice Higham's bound for
recursive summation, ``2 * (k - 1) * 2**-24 * sum|x|`` over the ``k``
chirps summed into an account (``k`` is its ``received``; every term
``src % 97`` is non-negative, so ``sum|x|`` is the checksum itself).
The engine twins mirror the fan-out and Chirper cases of
tests/test_sample_workloads.py, tests/test_fused.py and
tests/test_autofuse.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import DeviceFanout as JaxDeviceFanout
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor.fanout import _expand_kernel
from samples import chirper as jax_chirper

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.convert import fanout_from_adjacency
from orleans_tpu_torch.kernels.fanout import fanout_expand
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.samples.chirper import (
    build_follow_graph,
    run_chirper_load,
    run_chirper_load_fused,
)
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor.fanout import DeviceFanout, FanoutOverflowError
from orleans_tpu_torch.tensor.fused import CAUSE_FANOUT_REBUILD

SMALL_ADJ = {0: [1, 2, 3], 1: [2], 3: [0, 4]}


@pytest.fixture
def jax_trace_shim(monkeypatch):
    """The installed JAX lacks ``jax.core.trace_state_clean``, which the
    JAX attribution plane's flush calls (see tests/
    test_torch_attribution.py)."""
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _graphs(adj, budget):
    """The same graph as a JAX and a port DeviceFanout."""
    jf, pf = JaxDeviceFanout(budget=budget), DeviceFanout(budget=budget)
    for s, ds in adj.items():
        for d in ds:
            jf.follow(s, d)
            pf.follow(s, d)
    return jf, pf


def _in_degree(fan, n):
    deg = np.zeros(n, np.int64)
    for s in range(n):
        for d in fan.followers_of(s):
            deg[d] += 1
    return deg


# -- K11 against _expand_kernel -----------------------------------------------

@pytest.mark.parametrize("kind", ["power_law_1", "power_law_2", "masked",
                                  "empty_graph", "overflow"])
def test_expand_matches_jax(kind):
    """Power-law graphs (repeated and unknown source keys among the lanes),
    masked lanes, the empty graph's sentinel row, and a round whose
    duplicate sources need more slots than the width: the CSRs and all
    six outputs must be equal."""
    rng = np.random.default_rng(len(kind))
    if kind.startswith("power_law") or kind == "masked":
        seed = 7 if kind == "power_law_2" else 4
        jf = jax_chirper.build_follow_graph(300, 5.0, seed=seed)
        pf = build_follow_graph(300, 5.0, seed=seed)
        src = rng.integers(0, 320, 400).astype(np.int32)
    elif kind == "empty_graph":
        jf, pf = _graphs({}, 64)
        src = np.array([3, 0, KEY_SENTINEL], np.int32)
    else:
        jf, pf = _graphs({1: [100, 101, 102], 2: [7]}, 4)
        src = np.array([1, 2, 1, 1, 5], np.int32)
    valid = rng.random(len(src)) < (0.7 if kind == "masked" else 1.0)
    jcsr = jf._rebuild()
    pcsr = pf.csr(torch.device("cpu"))
    for got, want in zip(pcsr, jcsr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = _expand_kernel(*jcsr, jnp.asarray(src), jnp.asarray(valid))
    got = fanout_expand(*pcsr, _t(src), _t(valid))
    for name, g, w in zip(("dst", "src_index", "out_valid", "total",
                           "src_dropped", "n_dropped"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if kind == "overflow":
        assert int(got[5]) == 2 and got[4].tolist() == [False, False, True,
                                                       True, False]


def test_expand_of_no_messages():
    """m = 0: the JAX kernel fails to trace (a gather from an empty
    scan); the port returns the empty expansion, every slot invalid."""
    jf, pf = _graphs(SMALL_ADJ, 64)
    with pytest.raises(TypeError):
        _expand_kernel(*jf._rebuild(), jnp.zeros(0, jnp.int32),
                       jnp.zeros(0, bool))
    counter = torch.full((), 3, dtype=torch.int32)
    dst, src_index, out_valid, total, dropped, n = fanout_expand(
        *pf.csr(torch.device("cpu")), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool), counter)
    assert n is counter and int(counter) == 3 and int(total) == 0
    assert (dst == KEY_SENTINEL).all() and not out_valid.any()
    assert dst.shape == src_index.shape == (64,) and dropped.shape == (0,)
    d2, g2, v2 = pf.expand(torch.zeros(0, dtype=torch.int32),
                           {"v": torch.zeros(0), "s": np.float32(2)})
    assert not v2.any() and g2["v"].shape == (64,) and g2["s"] == 2
    assert pf.take_drop()[1].shape == (0,)


# -- twins of tests/test_sample_workloads.py ----------------------------------

def test_fanout_expansion_matches_adjacency():
    fan = DeviceFanout(budget=64)
    for s, ds in {1: [10, 11, 12], 2: [20], 5: [50, 51]}.items():
        for d in ds:
            fan.follow(s, d)
    src = _t(np.array([2, 1, 7, 5], np.int32))  # 7 has no followers
    args = {"v": _t(np.array([200, 100, 700, 500], np.int32))}
    dst, gargs, valid = fan.expand(src, args)
    dst, v, sk, valid = (dst.numpy(), gargs["v"].numpy(),
                         gargs["src_key"].numpy(), valid.numpy())
    got = sorted(zip(dst[valid].tolist(), v[valid].tolist(),
                     sk[valid].tolist()))
    assert got == sorted([(20, 200, 2), (10, 100, 1), (11, 100, 1),
                          (12, 100, 1), (50, 500, 5), (51, 500, 5)])
    assert (dst[~valid] == KEY_SENTINEL).all()
    assert fan.overflow_check() == 0


def test_fanout_mutation_and_empty_graph():
    fan = DeviceFanout(budget=16)
    src = _t(np.array([3], np.int32))
    _dst, _, valid = fan.expand(src, {"v": torch.zeros(1)})
    assert not valid.any()                      # empty graph
    version = fan.version
    fan.follow(3, 9)
    dst, _, valid = fan.expand(src, {"v": torch.zeros(1)})
    assert dst[valid].tolist() == [9] and fan.version == version + 1
    fan.unfollow(3, 9)                          # the mirror rebuilds lazily
    _dst, _, valid = fan.expand(src, {"v": torch.zeros(1)})
    assert not valid.any() and fan.version == version + 2


def test_fanout_overflow_parks_lanes_not_raises():
    fan = DeviceFanout(budget=4)
    for d in range(3):
        fan.follow(1, 100 + d)
    src = _t(np.array([1, 1], np.int32))
    dst, _gargs, valid = fan.expand(src, {"v": torch.zeros(2)})
    n_dropped, dropped = fan.take_drop()
    assert int(n_dropped) == 1 and dropped.tolist() == [False, True]
    assert sorted(dst[valid].tolist()) == [100, 101, 102]
    dst2, _g2, valid2 = fan.expand(src, {"v": torch.zeros(2)}, dropped)
    n2, _d2 = fan.take_drop()
    assert int(n2) == 0 and sorted(dst2[valid2].tolist()) == [100, 101, 102]
    assert fan.overflow_check() == 0
    over = DeviceFanout(budget=2)
    for d in range(3):
        over.follow(1, 200 + d)
    with pytest.raises(FanoutOverflowError):
        over.expand(_t(np.array([1], np.int32)), {"v": torch.zeros(1)})


def _chirper_engines(**cfg):
    cfg.setdefault("auto_fusion_ticks", 0)
    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg),
                         metrics=JaxMetricsConfig(attribution_enabled=False))
    pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg),
                      metrics=MetricsConfig(attribution_enabled=False))
    return je, pe


def _assert_accounts_match(je, pe):
    ja, pa = je.arena_for("ChirperAccount"), pe.arena_for("ChirperAccount")
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(keys, np.sort(pa.keys()))
    jrows, _ = ja.lookup_rows(keys)
    prows, _ = pa.lookup_rows(keys)
    for name, col in ja.state.items():
        want = np.asarray(col)[jrows]
        got = pa.state[name].numpy()[prows]
        assert got.dtype == want.dtype, name
        if want.dtype.kind == "f":
            k = np.asarray(ja.state["received"])[jrows]
            tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * np.abs(want)
            assert np.all(np.abs(got - want) <= tol), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_chirper_exact_small_graph(run):
    je, pe = _chirper_engines()
    jf, pf = _graphs(SMALL_ADJ, 64)
    run(jax_chirper.run_chirper_load(je, n_accounts=5, n_ticks=3,
                                     fanout=jf))
    stats = run(run_chirper_load(pe, n_accounts=5, n_ticks=3, fanout=pf))
    arena = pe.arena_for("ChirperAccount")
    rows = arena.resolve_rows(np.arange(5, dtype=np.int64))
    np.testing.assert_array_equal(arena.state["received"].numpy()[rows],
                                  3 * _in_degree(pf, 5))
    assert (arena.state["published"].numpy()[rows] == 3).all()
    assert stats["messages"] == 3 * (5 + 6)
    _assert_accounts_match(je, pe)


def test_chirper_power_law_load(run):
    je, pe = _chirper_engines()
    jf = jax_chirper.build_follow_graph(200, mean_followers=8.0, seed=3)
    pf = build_follow_graph(200, mean_followers=8.0, seed=3)
    assert pf._adj == jf._adj and pf.edge_count == jf.edge_count
    run(jax_chirper.run_chirper_load(je, n_accounts=200, n_ticks=2,
                                     fanout=jf))
    run(run_chirper_load(pe, n_accounts=200, n_ticks=2, fanout=pf))
    arena = pe.arena_for("ChirperAccount")
    rows = arena.resolve_rows(np.arange(200, dtype=np.int64))
    deg_in = _in_degree(pf, 200)
    np.testing.assert_array_equal(arena.state["received"].numpy()[rows],
                                  2 * deg_in)
    deg = np.asarray([len(pf.followers_of(s)) for s in range(200)])
    assert deg.max() >= 10 * max(1, int(np.median(deg)))
    _assert_accounts_match(je, pe)


def test_fanout_no_duplicate_delivery_on_miss_redelivery(run):
    """Publishes from unseen keys through the device path: the miss-check
    redelivery expands the fan-out once, never twice."""

    async def drive(eng, fan, asarray):
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        eng.send_batch("ChirperAccount", "publish",
                       asarray(np.array([1, 2], np.int32)),
                       {"chirp_id": asarray(np.array([100, 200],
                                                     np.int32))})
        await eng.flush()

    je, pe = _chirper_engines()
    adj = {1: [10, 11], 2: [10]}
    jf, pf = _graphs(adj, 64)
    run(drive(je, jf, jnp.asarray))
    run(drive(pe, pf, torch.from_numpy))
    arena = pe.arena_for("ChirperAccount")
    rows = arena.resolve_rows(np.array([1, 2, 10, 11], np.int64))
    np.testing.assert_array_equal(arena.state["received"].numpy()[rows],
                                  [0, 0, 2, 1])
    np.testing.assert_array_equal(arena.state["published"].numpy()[rows],
                                  [1, 1, 0, 0])
    _assert_accounts_match(je, pe)


# -- twins of tests/test_fused.py and tests/test_autofuse.py ------------------

def test_fused_chirper_fanout():
    """The registered fan-out runs inside the fused window: deliveries
    match the adjacency exactly across the window, and JAX's window."""
    T = 4
    accounts = np.arange(5, dtype=np.int64)

    def drive(eng, fan, stacked):
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        eng.arena_for("ChirperAccount").resolve_rows(accounts)
        prog = eng.fuse_ticks("ChirperAccount", "publish", accounts)
        for _window in range(2):
            prog.run({"chirp_id": stacked})
        assert prog.verify() == 0
        return prog

    je, pe = _chirper_engines()
    jf, pf = _graphs(SMALL_ADJ, 1024)
    ids = np.broadcast_to(np.arange(5, dtype=np.int32), (T, 5))
    drive(je, jf, jnp.asarray(ids))
    prog = drive(pe, pf, torch.from_numpy(ids.copy()))
    # the graph was built inside the first window's build: no rebuild after
    assert dict(prog.rebuilds) == {"new_window": 1}
    arena = pe.arena_for("ChirperAccount")
    rows = arena.resolve_rows(accounts)
    np.testing.assert_array_equal(arena.state["received"].numpy()[rows],
                                  2 * T * _in_degree(pf, 5))
    np.testing.assert_array_equal(arena.state["published"].numpy()[rows],
                                  2 * T)
    _assert_accounts_match(je, pe)


def test_fused_chirper_loader_matches_unfused(run):
    e1 = TensorEngine(device="cpu")
    run(run_chirper_load(e1, n_accounts=150, n_ticks=4,
                         fanout=build_follow_graph(150, 6.0, seed=5)))
    a1 = e1.arena_for("ChirperAccount")
    ref = a1.state["received"].numpy()[a1.resolve_rows(np.arange(150))]
    je, pe = _chirper_engines()
    run(jax_chirper.run_chirper_load_fused(
        je, n_accounts=150, n_ticks=4, window=2,
        fanout=jax_chirper.build_follow_graph(150, 6.0, seed=5)))
    stats = run(run_chirper_load_fused(
        pe, n_accounts=150, n_ticks=4, window=2,
        fanout=build_follow_graph(150, 6.0, seed=5)))
    a2 = pe.arena_for("ChirperAccount")
    got = a2.state["received"].numpy()[a2.resolve_rows(np.arange(150))]
    np.testing.assert_array_equal(got * 4, ref * (stats["ticks"] + 2))
    _assert_accounts_match(je, pe)


def test_chirper_autofuses_with_fanout(jax_trace_shim, run):
    """Auto-fusion engages on a pattern with a registered fan-out and
    matches the unfused engine and the JAX engine (attribution on: the
    JAX side needs the trace shim)."""
    n_accounts, T = 400, 24
    plain = TensorEngine(device="cpu", config=TensorEngineConfig(
        auto_fusion_ticks=0))
    run(run_chirper_load(plain, n_accounts=n_accounts, n_ticks=T,
                         fanout=build_follow_graph(n_accounts, 8.0, seed=3)))
    cfg = dict(auto_fusion_ticks=4, auto_fusion_window=4)
    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg))
    auto = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))
    run(jax_chirper.run_chirper_load(
        je, n_accounts=n_accounts, n_ticks=T,
        fanout=jax_chirper.build_follow_graph(n_accounts, 8.0, seed=3)))
    run(run_chirper_load(auto, n_accounts=n_accounts, n_ticks=T,
                         fanout=build_follow_graph(n_accounts, 8.0, seed=3)))
    assert auto.autofuser.ticks_fused > 0, "fan-out pattern never engaged"
    assert auto.autofuser.snapshot() == je.autofuser.snapshot()
    keys = np.arange(n_accounts, dtype=np.int64)
    a_ref, a_auto = (plain.arena_for("ChirperAccount"),
                     auto.arena_for("ChirperAccount"))
    for col in ("received", "published", "last_chirp"):
        np.testing.assert_array_equal(
            a_auto.state[col].numpy()[a_auto.resolve_rows(keys)],
            a_ref.state[col].numpy()[a_ref.resolve_rows(keys)],
            err_msg=f"ChirperAccount.{col} diverged under autofuse")
    _assert_accounts_match(je, auto)


def test_chirper_slice_matches_jax(jax_trace_shim, run):
    """Both engines with the ledger and the attribution plane on, a short
    auto-fusion (3 ticks, 4-tick windows, verify every 2) and a cold
    start (no account activated before the first publish): columns,
    counters, the ledger and the plane's per-key totals and hot lists
    must agree."""
    n_accounts, T = 300, 20
    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4,
               auto_fusion_verify_windows=2)
    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg))
    pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))
    run(jax_chirper.run_chirper_load(
        je, n_accounts=n_accounts, n_ticks=T,
        fanout=jax_chirper.build_follow_graph(n_accounts, 6.0, seed=11)))
    run(run_chirper_load(pe, n_accounts=n_accounts, n_ticks=T,
                         fanout=build_follow_graph(n_accounts, 6.0,
                                                   seed=11)))
    af = pe.autofuser.snapshot()
    assert af == je.autofuser.snapshot() and af["windows_run"] >= 2
    assert pe.messages_processed == je.messages_processed
    assert pe.tick_number == je.tick_number
    _assert_accounts_match(je, pe)
    want, got = je.ledger.snapshot(), pe.ledger.snapshot()
    assert {k: (v["counts"], v["total"]) for k, v in got.items()} == \
        {k: (v["counts"], v["total"]) for k, v in want.items()}
    assert pe.attribution.per_key_totals("ChirperAccount") == \
        je.attribution.per_key_totals("ChirperAccount")
    w = je.attribution.snapshot()["arenas"]["ChirperAccount"]
    g = pe.attribution.snapshot()["arenas"]["ChirperAccount"]
    assert g["hot"] == w["hot"] and g["total_msgs"] == w["total_msgs"]


# -- the repairs and the reference's fault ------------------------------------

def test_parked_fanout_check_redelivers_enqueue_time_payload(run):
    """A round whose duplicate sources overflow the width parks the second
    lane with copies of its keys and payload; the loader then rewrites
    its ``chirp_id`` tensor in place before the drain.  The drain must
    expand what was published, as the JAX package does."""
    keys = np.array([1, 1], np.int64)

    async def drive(eng, fan, chirp, rewrite):
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        eng.arena_for("ChirperAccount").resolve_rows(
            np.array([1, 100, 101, 102], np.int64))
        inj = eng.make_injector("ChirperAccount", "publish", keys)
        inj.inject({"chirp_id": chirp})
        await eng.drain_queues()  # lane 1 overflows the width: parked
        rewrite(chirp)
        await eng.flush()

    je, pe = _chirper_engines()
    jf, pf = _graphs({1: [100, 101, 102]}, 4)
    run(drive(je, jf, jnp.asarray(np.array([10, 20], np.int32)),
              lambda c: None))
    run(drive(pe, pf, torch.tensor([10, 20], dtype=torch.int32),
              lambda c: c.copy_(torch.tensor([30, 40]))))
    assert pf.redeliveries == jf.redeliveries == 1
    assert pf.dropped_lanes == jf.dropped_lanes == 1
    arena = pe.arena_for("ChirperAccount")
    rows = arena.resolve_rows(np.array([100, 101, 102], np.int64))
    np.testing.assert_array_equal(arena.state["last_chirp"].numpy()[rows],
                                  20)
    np.testing.assert_array_equal(arena.state["received"].numpy()[rows], 2)
    _assert_accounts_match(je, pe)


def test_window_after_follow_equals_unfused_jax():
    """The follow graph changes between two fused windows.  The JAX window
    keeps the graph it was traced with, so the new follower of account 3
    gets nothing from its second window; the port's window rebuilds on
    the fan-out's new CSR and equals the JAX package's UNFUSED engine."""
    adj = {0: [1, 2], 1: [2]}
    accounts = np.arange(4, dtype=np.int64)

    def ids(t0):
        return (np.arange(2, dtype=np.int32)[:, None] * 4
                + np.arange(4, dtype=np.int32)[None] + t0 * 4)

    def windows(eng, fan, asarray):
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        eng.arena_for("ChirperAccount").resolve_rows(accounts)
        prog = eng.fuse_ticks("ChirperAccount", "publish", accounts)
        prog.run({"chirp_id": asarray(ids(0))})
        fan.follow(3, 0)
        prog.run({"chirp_id": asarray(ids(2))})
        assert prog.verify() == 0
        return prog

    def received(eng):
        a = eng.arena_for("ChirperAccount")
        return np.asarray(a.state["received"])[a.resolve_rows(accounts)]

    jw, _ = _chirper_engines()
    jf_w, pf = _graphs(adj, 64)
    windows(jw, jf_w, jnp.asarray)
    ju, pe = _chirper_engines()
    jf_u, _ = _graphs(adj, 64)
    ju.register_fanout("ChirperAccount", "publish", jf_u,
                       "ChirperAccount", "new_chirp")
    ju.arena_for("ChirperAccount").resolve_rows(accounts)
    inj = ju.make_injector("ChirperAccount", "publish", accounts)
    for t in range(4):
        if t == 2:
            jf_u.follow(3, 0)
        inj.inject({"chirp_id": jnp.asarray(ids(0).reshape(-1)[:4]
                                            + 4 * t)})
        ju.run_tick()
        ju.run_tick()
    prog = windows(pe, pf, torch.from_numpy)
    np.testing.assert_array_equal(received(ju), [2, 4, 8, 0])
    np.testing.assert_array_equal(received(jw), [0, 4, 8, 0])
    np.testing.assert_array_equal(received(pe), received(ju))
    assert prog.rebuilds[CAUSE_FANOUT_REBUILD] == 1
    _assert_accounts_match(ju, pe)


def test_fanout_carried_across_matches_jax():
    """A JAX follow graph carried into the port (its adjacency lists and
    budget) expands the same messages into the same slots."""
    jf = jax_chirper.build_follow_graph(250, 4.0, seed=9)
    jf.follow(3, 7)
    pf = fanout_from_adjacency(jf._adj, jf.budget)
    assert pf.edge_count == jf.edge_count and pf.budget == jf.budget
    src = np.random.default_rng(4).integers(0, 260, 300).astype(np.int32)
    args = {"v": np.arange(300, dtype=np.int32)}
    want = jf.expand(jnp.asarray(src), {"v": jnp.asarray(args["v"])})
    got = pf.expand(_t(src), {"v": _t(args["v"])})
    for g, w in ((got[0], want[0]), (got[1]["v"], want[1]["v"]),
                 (got[1]["src_key"], want[1]["src_key"]),
                 (got[2], want[2])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_follow_mid_window_runs_buffered_ticks_on_their_graph(run):
    """A follow() while the auto-fuser holds buffered ticks: those ticks
    were published before it, so they run first, on the old graph; the
    next window rebuilds on the new one.  Equal to the JAX package's
    unfused engine following at the same tick."""
    n, T, follow_at = 60, 26, 17
    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4)

    async def drive(eng, fan, asarray):
        eng.register_fanout("ChirperAccount", "publish", fan,
                            "ChirperAccount", "new_chirp")
        inj = eng.make_injector("ChirperAccount", "publish",
                                np.arange(n, dtype=np.int64))
        for t in range(T):
            if t == follow_at:
                fan.follow(7, 3)
                fan.follow(n - 1, 0)
            inj.inject({"chirp_id": asarray(np.arange(n, dtype=np.int32)
                                            + t * n)})
            await eng.drain_queues()
        await eng.flush()

    ju = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0,
                                                auto_fusion_ticks=0),
                         metrics=JaxMetricsConfig(attribution_enabled=False))
    _je, pe = _chirper_engines(**cfg)
    run(drive(ju, jax_chirper.build_follow_graph(n, 3.0, seed=1),
              jnp.asarray))
    fan = build_follow_graph(n, 3.0, seed=1)
    run(drive(pe, fan, torch.from_numpy))
    af = pe.autofuser.snapshot()
    assert af["windows_run"] >= 3 and af["windows_rolled_back"] == 0
    prog = next(iter(pe.autofuser._programs.values()))
    assert prog.rebuilds[CAUSE_FANOUT_REBUILD] == 1
    _assert_accounts_match(ju, pe)
