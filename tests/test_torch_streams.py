"""Differential tests of the port's device streams plane against the JAX
package.

A registered ``DeviceSubscriptions`` fans every message of a stream's
ingress method out to the stream's subscribers: pull-mode (one payload
gather per edge, the subscriber's row-range reductions through K16
``seg_pull`` and the dense touch K17 ``touch_dense``, here their plain
versions) when the publish is the bound key set, push-mode (K11)
otherwise.  The same seeded graphs and loads, made with numpy, go through
``orleans_tpu`` (JAX on the CPU) and ``orleans_tpu_torch`` on
``device="cpu"``; integer columns, use clocks, the ``streams`` counters
and the ledger must be equal.  Float32 pull-mode sums are compared within
``2 * 2**-24 * sum|x|`` over the batch: JAX's prefix-sum difference
carries about ``eps32`` times the batch's running total, the port's row
sum about ``eps32`` times the row's.

The engine twins mirror the device cases of tests/test_streams_plane.py
(the SQLite, pulling-agent, pub-sub, metrics and perfgate cases wait for
the port's host integration).  The installed JAX lacks
``jax.core.trace_state_clean``, which its pull layout and its attribution
flush call: the ``jax_trace_shim`` fixture sets it per test.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.streams as jax_streams
from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import DeviceSubscriptions as JaxSubscriptions
from orleans_tpu.tensor import MemoryVectorStore as JaxMemoryVectorStore
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor.arena import _touch_dense_kernel
from orleans_tpu.tensor.attribution import fold_counts as jax_fold_counts
from orleans_tpu.tensor.vector_grain import seg_max as jax_seg_max
from orleans_tpu.tensor.vector_grain import seg_sum as jax_seg_sum

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.convert import subscriptions_from_jax
from orleans_tpu_torch.kernels.pull import seg_pull, touch_dense
from orleans_tpu_torch.samples import streams as port_streams
from orleans_tpu_torch.tensor import DeviceSubscriptions, TensorEngine
from orleans_tpu_torch.tensor.attribution import fold_counts
from orleans_tpu_torch.tensor.fused import CAUSE_STREAM_REBUILD
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore
from orleans_tpu_torch.tensor.vector_grain import seg_max, seg_sum


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


_JAX_PULL = {}


def _jax_pull(fn, vals, seg, n_rows: int, **kw) -> np.ndarray:
    """A JAX ``segments`` branch, jitted as the JAX engine's step runs it
    (the eager associative scan of ``seg_max`` takes seconds to trace);
    one program per branch and row count, shared by the cases."""
    key = (fn, n_rows, tuple(sorted(kw.items())))
    prog = _JAX_PULL.get(key)
    if prog is None:
        prog = _JAX_PULL[key] = jax.jit(
            lambda v, s: fn(v, None, n_rows, segments=s, **kw))
    return np.asarray(prog(jnp.asarray(vals), jnp.asarray(seg)))


def _segments(rng, n_rows: int, m: int, empty_every: int = 0):
    """Row-aligned offsets over ``m`` lanes (some rows empty)."""
    rows = np.sort(rng.integers(0, n_rows, m)).astype(np.int32)
    if empty_every:
        rows = rows[rows % empty_every != 0]
    seg = np.zeros(n_rows + 1, np.int32)
    seg[1:] = np.cumsum(np.bincount(rows, minlength=n_rows))
    return rows, seg


# -- K16 and K17 against the JAX branches -------------------------------------

@pytest.mark.parametrize("case", ["int32", "int32_wraps", "float32", "bool",
                                  "short_offsets"])
def test_seg_pull_matches_jax(case):
    """Pull-mode ``seg_sum`` / ``seg_max`` (K16's plain version) against
    the JAX ``segments`` branches: empty rows read ``fill``, int32 sums
    are bit-equal even where the batch's running total wraps past 2**31,
    float32 sums agree within the stated bound, lanes past
    ``offsets[-1]`` belong to no row; and the pull path equals the
    scatter path where the lanes are grouped by row."""
    rng = np.random.default_rng(0)
    n_rows, m = 257, 4_000
    rows, seg = _segments(rng, n_rows, m, empty_every=5)
    m_used = len(rows)
    extra = 37
    rows_all = np.concatenate([rows, np.full(extra, -1, np.int32)])
    if case != "short_offsets":   # offsets[-1] == m
        seg = seg.copy()
        seg[-1] += extra
        rows_all[-extra:] = n_rows - 1
    if case == "int32_wraps":
        vals = rng.integers(2**29, 2**30, m_used + extra).astype(np.int32)
    elif case == "float32":
        vals = rng.standard_normal(m_used + extra).astype(np.float32) * 1e3
    elif case == "bool":
        vals = rng.random(m_used + extra) < 0.6
    else:
        vals = rng.integers(-50, 50, m_used + extra).astype(np.int32)
    want = _jax_pull(jax_seg_sum, vals, seg, n_rows)
    got = seg_sum(_t(vals), _t(rows_all), n_rows, segments=_t(seg)).numpy()
    assert got.dtype == want.dtype
    if case == "float32":
        tol = 2 * 2.0**-24 * np.abs(vals[:m_used]).astype(np.float64).sum()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)
        if case == "int32_wraps":
            assert np.abs(vals.astype(np.int64)).sum() > 2**31
    # the scatter path over the same grouped lanes
    ints = vals.astype(np.int32) if case == "bool" else vals
    scatter = seg_sum(_t(ints), _t(rows_all), n_rows).numpy()
    if case != "float32":
        np.testing.assert_array_equal(got, scatter)
    if case == "bool":
        return
    fill = vals.dtype.type(-99)
    want_max = _jax_pull(jax_seg_max, vals, seg, n_rows, fill=fill)
    got_max = seg_max(_t(vals), _t(rows_all), n_rows, segments=_t(seg),
                      fill=fill).numpy()
    np.testing.assert_array_equal(got_max, want_max)
    empty = seg[1:] == seg[:-1]
    assert empty.any() and (got_max[empty] == fill).all()
    scatter_max = seg_max(_t(vals), _t(rows_all), n_rows).numpy()
    np.testing.assert_array_equal(got_max[~empty], scatter_max[~empty])


def test_fold_counts_segments_matches_jax():
    """``fold_counts`` with ``segments`` (K16's count mode): the per-row
    counts of valid lanes add into the column, every valid lane (those
    past ``offsets[-1]`` included) into the slot."""
    rng = np.random.default_rng(3)
    n_rows, m = 300, 2_500
    rows, seg = _segments(rng, n_rows, m, empty_every=7)
    valid = rng.random(len(rows) + 11) < 0.7
    rows_all = np.concatenate([rows, np.full(11, -1, np.int32)])
    counts0 = rng.integers(0, 9, n_rows).astype(np.int32)
    slots0 = rng.integers(0, 9, 8).astype(np.int32)
    jc, js = jax_fold_counts(jnp.asarray(counts0), jnp.asarray(slots0),
                             jnp.int32(5), jnp.asarray(rows_all),
                             jnp.asarray(valid), segments=jnp.asarray(seg))
    counts, slots = _t(counts0), _t(slots0)
    fold_counts(counts, slots, 5, _t(rows_all), _t(valid), segments=_t(seg))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    # the slot counts the lanes past offsets[-1] too
    assert slots[5] - slots0[5] == valid.sum()
    out = seg_pull(_t(valid), _t(seg), "sum")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jc) - counts0)


def test_touch_dense_matches_jax():
    rng = np.random.default_rng(4)
    n_rows = 513
    _rows, seg = _segments(rng, n_rows, 900, empty_every=3)
    clock = rng.integers(0, 40, n_rows).astype(np.int32)
    clock[::11] = -4   # an empty row keeps max(clock, 0)
    want = np.asarray(_touch_dense_kernel(jnp.asarray(clock),
                                          jnp.asarray(seg), jnp.int32(25)))
    got = _t(clock)
    touch_dense(got, _t(seg), 25)
    np.testing.assert_array_equal(got.numpy(), want)


# -- engine twins -------------------------------------------------------------

_USER = ("ChatUserGrain", "ChatRoomGrain")


def _sides(store=False, initial_capacity=1024, attribution=False, **cfg):
    """The JAX side and the port side of one scenario, each a namespace
    with ``engine`` (a ``MemoryVectorStore`` behind it when ``store``),
    ``Subs``, ``sample``, ``dev`` (an array on the side's device) and
    ``port``.  The attribution plane is off unless asked for: its JAX
    programs compile anew for every edge count a rebuild brings, which
    would double this file's time; the sample loads and ``churn_points``
    run it (pull-mode folds, and evictions retiring counts and edges
    together)."""
    cfg.setdefault("auto_fusion_ticks", 0)
    j = types.SimpleNamespace(
        engine=JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0,
                                                      **cfg),
                               store=JaxMemoryVectorStore() if store
                               else None,
                               initial_capacity=initial_capacity,
                               metrics=JaxMetricsConfig(
                                   attribution_enabled=attribution)),
        Subs=JaxSubscriptions, sample=jax_streams,
        dev=lambda a: jnp.asarray(np.asarray(a)), port=False)
    j.stats = j.engine.snapshot
    p = types.SimpleNamespace(
        engine=TensorEngine(config=TensorEngineConfig(**cfg), device="cpu",
                            store=MemoryVectorStore() if store else None,
                            initial_capacity=initial_capacity,
                            metrics=MetricsConfig(
                                attribution_enabled=attribution)),
        Subs=DeviceSubscriptions, sample=port_streams,
        dev=lambda a: torch.as_tensor(np.asarray(a)), port=True)
    p.stats = p.engine.stats
    return j, p


def _wire(s, n_rooms, n_users, mean=2.0, seed=0):
    """The JAX test file's ``_wire``: adjacency, route, active members,
    bound rooms."""
    subs = s.Subs(s.engine, "ChatUserGrain", "receive")
    streams, members = s.sample.build_membership(n_rooms, n_users, mean,
                                                 seed=seed)
    subs.subscribe_many(streams, members)
    s.engine.register_subscriptions("ChatRoomGrain", "publish", subs)
    s.engine.arena_for("ChatUserGrain").reserve(n_users)
    s.engine.arena_for("ChatUserGrain").resolve_rows(
        np.arange(n_users, dtype=np.int64))
    s.engine.arena_for("ChatRoomGrain").reserve(n_rooms)
    subs.bind(np.arange(n_rooms, dtype=np.int64))
    s.subs = subs
    return subs


def _assert_twins(j, p, type_names=_USER):
    """Arena by arena: row layout, every state column, the device use
    clock and the attribution plane's per-key totals equal; the engine
    counters and the ``streams`` counters equal."""
    je, pe = j.engine, p.engine
    for t in type_names:
        ja, pa = je.arena_for(t), pe.arena_for(t)
        np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
        for attr in ("live_count", "eviction_epoch", "generation"):
            assert getattr(pa, attr) == getattr(ja, attr), (t, attr)
        for name, col in ja.state.items():
            np.testing.assert_array_equal(pa.state[name].numpy(),
                                          np.asarray(col),
                                          err_msg=f"{t}.{name}")
        np.testing.assert_array_equal(pa.last_use_dev.numpy(),
                                      np.asarray(ja.last_use_dev),
                                      err_msg=f"{t} last_use_dev")
        if je.attribution.has_state(t):
            assert pe.attribution.per_key_totals(t) == \
                je.attribution.per_key_totals(t), t
    for attr in ("tick_number", "messages_processed"):
        assert getattr(pe, attr) == getattr(je, attr), attr
    assert p.stats()["streams"] == j.stats()["streams"]


def _twin(run, scenario, type_names=_USER, **kw):
    j, p = _sides(**kw)
    run(scenario(j))
    run(scenario(p))
    _assert_twins(j, p, type_names)
    return j, p


def _user_received(s, n_users):
    arena = s.engine.arena_for("ChatUserGrain")
    rows, ok = arena.lookup_rows(np.arange(n_users, dtype=np.int64))
    col = arena.state["received"]
    col = col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)
    return col[rows], ok


def _oracle_exact(oracle) -> bool:
    return all(v for k, v in oracle.items() if k.endswith("_exact"))


@pytest.mark.parametrize("load", ["chat", "leaderboard", "chat_fused"])
def test_sample_load_matches_jax(run, jax_trace_shim, load):
    """``run_chat_load`` (unfused, oracle on), ``run_leaderboard_load``
    (oracle on) and ``run_chat_load_fused`` (windows of 16 at the default
    config: ledger and attribution on) at 64 streams / 2,000 subscribers /
    1.5 memberships, column by column against JAX.  The steady pattern
    rides the pull path ([chat] is the twin of
    test_streams_plane.py::test_pull_delivery_matches_host_oracle)."""
    out = {}

    async def go(s):
        e = s.engine
        if load == "chat":
            st = await s.sample.run_chat_load(
                e, n_rooms=64, n_users=2_000, mean_memberships=1.5,
                n_ticks=6, verify=True)
            assert _oracle_exact(st["oracle"]), st["oracle"]
        elif load == "leaderboard":
            st = await s.sample.run_leaderboard_load(
                e, n_boards=64, n_members=2_000, mean_follows=1.5,
                n_ticks=4, verify=True)
            assert _oracle_exact(st["oracle"]), st["oracle"]
        else:
            st = await s.sample.run_chat_load_fused(
                e, n_rooms=64, n_users=2_000, mean_memberships=1.5,
                n_ticks=32, window=16)
        out[s.port] = st

    kind = ("BoardMemberGrain", "LeaderboardGrain") if load == "leaderboard" \
        else _USER
    cfg = {"auto_fusion_ticks": 16 if load == "chat_fused" else 0}
    j, p = _twin(run, go, type_names=kind, attribution=True, **cfg)
    assert out[True]["edges"] == out[False]["edges"]
    streams = p.stats()["streams"]
    (route,) = streams.values()
    if load != "chat_fused":
        assert route["pull_deliveries"] > 0 and route["push_deliveries"] == 0
    else:
        assert p.engine.ledger.fetch_counts().tolist() == \
            j.engine.ledger.fetch_counts().tolist()


async def _host_expand_and_mutations(s):
    subs = s.Subs(None, "ChatUserGrain", "receive")
    subs.subscribe_many([1, 1, 2, 5], [10, 11, 20, 50])
    subs.subscribe(2, 21)
    subs.unsubscribe(1, 11)
    subs.subscribe(9, 90)
    subs.unsubscribe(9, 90)
    s.out = (subs.edge_count, subs.edges().copy(),
             subs.subscribers_of(2).tolist(), subs.subscribers_of(9).tolist(),
             subs.host_expand(np.array([2, 1, 7], dtype=np.int64)))


async def _push_unbound(s):
    subs = _wire(s, 32, 500)
    some = np.array([3, 7, 11], dtype=np.int64)
    s.engine.send_batch("ChatRoomGrain", "publish",
                        s.dev(some.astype(np.int32)),
                        {"msg_id": s.dev(np.array([100, 101, 102],
                                                  np.int32))})
    await s.engine.flush()
    got, _ok = _user_received(s, 500)
    exp = np.zeros(500, np.int64)
    np.add.at(exp, subs.host_expand(some)[0], 1)
    np.testing.assert_array_equal(got, exp)
    assert subs.push_deliveries > 0


async def _churn_rebuilds(s):
    subs = _wire(s, 32, 1_000)
    s1 = await s.sample.run_chat_load(s.engine, n_rooms=32, n_users=1_000,
                                      n_ticks=3, subs=subs, verify=True)
    v0 = subs.layout_version
    subs.subscribe_many([1, 1, 2], [998, 999, 999])
    drop = subs.subscribers_of(5)
    if len(drop):
        subs.unsubscribe_many(np.full(1, 5), drop[:1])
    s2 = await s.sample.run_chat_load(s.engine, n_rooms=32, n_users=1_000,
                                      n_ticks=3, seed=1, subs=subs,
                                      verify=True, mirror=s1["mirror"])
    assert subs.layout_version > v0
    assert _oracle_exact(s2["oracle"]), s2["oracle"]


async def _evicted_row_reuse(s):
    subs = _wire(s, 8, 200)
    await s.sample.run_chat_load(s.engine, n_rooms=8, n_users=200,
                                 n_ticks=2, subs=subs)
    arena = s.engine.arena_for("ChatUserGrain")
    victim = int(subs.subscribers_of(0)[0])
    old_row = int(arena.lookup_rows(np.array([victim]))[0][0])
    arena.evict_keys(np.array([victim]), write_back=False)
    stranger = np.array([9_000], dtype=np.int64)
    arena.resolve_rows(stranger)
    s_rows, ok = arena.lookup_rows(stranger)
    assert ok[0] and int(s_rows[0]) == old_row   # LIFO slot reuse
    inj = s.engine.make_injector("ChatRoomGrain", "publish",
                                 np.arange(8, dtype=np.int64))
    inj.inject({"msg_id": np.arange(8, dtype=np.int32) + 500})
    await s.engine.flush()
    recv = arena.state["received"]
    recv = recv.numpy() if s.port else np.asarray(recv)
    assert int(recv[int(arena.lookup_rows(stranger)[0][0])]) == 0
    v_rows, v_ok = arena.lookup_rows(np.array([victim]))
    assert v_ok[0]
    assert int(recv[int(v_rows[0])]) == int(np.sum(subs.edges()[:, 1]
                                                   == victim))
    assert subs.retired_edges > 0


async def _stale_pull_batch(s):
    """A pull delivery queued under one eviction epoch runs under another
    (the round cap of 1 spills it to the next tick, an eviction lands in
    between): it is delivered again by key, the evicted subscriber
    re-activates, and the next publish takes the pull path again."""
    subs = _wire(s, 8, 200)
    rooms = np.arange(8, dtype=np.int64)
    mirror = s.sample._HostMirror(subs, 200)
    inj = s.engine.make_injector("ChatRoomGrain", "publish", rooms)
    for t in range(2):
        msg = np.arange(8, dtype=np.int32) + 300 + 8 * t
        inj.inject({"msg_id": msg})
        s.engine.run_tick()   # the publish applies, its delivery spills
        assert s.engine.queues[("ChatUserGrain", "receive")]
        if t == 0:
            victim = np.array([subs.subscribers_of(0)[0]], dtype=np.int64)
            s.engine.arena_for("ChatUserGrain").evict_keys(
                victim, write_back=False)
        await s.engine.flush()
        mirror.publish(rooms, msg.astype(np.int64))
        oracle = s.sample.check_chat_exact(s.engine, 200, mirror)
        assert _oracle_exact(oracle) and oracle["live_subscribers"] == 200
    assert subs.pull_deliveries == 2 and subs.push_deliveries == 0


async def _randomized_churn(s):
    """The first five rounds of the JAX test's eight: a publish, a
    subscribe, an unsubscribe and an eviction with slot reuse (its
    publish goes push-mode to the cold subscribers and re-activates
    them), then a publish back on the pull path; exact after each."""
    n_rooms, n_users = 16, 400
    subs = _wire(s, n_rooms, n_users)
    rooms = np.arange(n_rooms, dtype=np.int64)
    inj = s.engine.make_injector("ChatRoomGrain", "publish", rooms)
    mirror = s.sample._HostMirror(subs, n_users)
    arena = s.engine.arena_for("ChatUserGrain")
    rng = np.random.default_rng(42)
    for rnd in range(5):
        op = rnd % 4
        if op == 1:
            subs.subscribe_many(rng.integers(0, n_rooms, 5),
                                rng.integers(0, n_users, 5))
        elif op == 2:
            e = subs.edges()
            pick = e[rng.integers(0, len(e), 3)]
            subs.unsubscribe_many(pick[:, 0], pick[:, 1])
        elif op == 3:
            victims = rng.choice(n_users, 20, replace=False).astype(np.int64)
            arena.evict_keys(victims, write_back=True)
            mirror.evict_keys(victims)
            arena.resolve_rows(np.arange(10, dtype=np.int64) + 10_000
                               + rnd * 100)
        msg = rng.integers(0, 10_000, n_rooms).astype(np.int32)
        inj.inject({"msg_id": msg})
        await s.engine.flush()
        mirror.publish(rooms, msg.astype(np.int64))
        oracle = s.sample.check_chat_exact(s.engine, n_users, mirror)
        assert _oracle_exact(oracle), (rnd, oracle)
    assert subs.push_deliveries == 1 and subs.pull_deliveries == 4


async def _overflow_redelivery(s):
    subs = s.Subs(s.engine, "ChatUserGrain", "receive")
    # 300 edges on one stream: width 512; two publishes of it need 600
    subs.subscribe_many(np.zeros(300, np.int64),
                        np.arange(300, dtype=np.int64))
    s.engine.register_subscriptions("ChatRoomGrain", "publish", subs)
    s.engine.arena_for("ChatUserGrain").reserve(300)
    s.engine.arena_for("ChatUserGrain").resolve_rows(
        np.arange(300, dtype=np.int64))
    s.engine.arena_for("ChatRoomGrain").reserve(4)
    s.engine.send_batch("ChatRoomGrain", "publish",
                        s.dev(np.zeros(2, np.int32)),
                        {"msg_id": s.dev(np.array([7, 8], np.int32))})
    await s.engine.flush()
    got, _ok = _user_received(s, 300)
    np.testing.assert_array_equal(got, 2)
    assert subs.dropped_lanes >= 1 and subs.redeliveries >= 1
    counts = s.engine.ledger.fetch_counts()
    slot = s.engine.ledger.slot_for("ChatUserGrain", "receive")
    assert counts[slot, 1:].sum() > 0   # redelivered at the original stamp
    s.ledger = counts


async def _wide_stream_key(s):
    _wire(s, 8, 100)
    wide = np.array([2**40 + 5], dtype=np.int64)
    s.engine.send_batch("ChatRoomGrain", "publish", wide,
                        {"msg_id": np.array([1], np.int32)})
    await s.engine.flush()   # no OverflowError
    assert s.engine.arena_for("ChatRoomGrain").lookup_rows(wide)[1][0]


async def _rollback_mutation_settled(s):
    subs = _wire(s, 8, 100, mean=1.0)
    rooms = np.arange(8, dtype=np.int64)
    inj = s.engine.make_injector("ChatRoomGrain", "publish", rooms)
    for t in range(10):
        inj.inject({"msg_id": np.arange(8, dtype=np.int32) + 8 * t})
        await s.engine.drain_queues()
    assert s.engine.autofuser._unverified
    subs.subscribe(0, 50_000)
    assert not s.engine.autofuser._unverified   # settled first
    await s.engine.flush()
    got, _ok = _user_received(s, 100)
    exp = np.zeros(100, np.int64)
    dsts, _ = subs.host_expand(rooms)
    np.add.at(exp, dsts[dsts < 100], 10)
    np.testing.assert_array_equal(got, exp)


async def _churn_points(s):
    """bench.py ``_streams_churn_exactness`` at 2,000 users / 32 rooms:
    exact at every churn point, reused rows clean.  Its last two points
    (the plane switched off, the host path delivering; switched back on)
    are test_streams_plane.py::test_live_toggle_host_path_delivers_and_
    retraces."""
    n_users, n_rooms = 2_000, 32
    subs = s.Subs(s.engine, "ChatUserGrain", "receive")
    streams, members = s.sample.build_membership(n_rooms, n_users, 2.0,
                                                 seed=7)
    subs.subscribe_many(streams, members)
    mirror = s.sample._HostMirror(subs, n_users)
    rng = np.random.default_rng(7)
    points = []

    async def publish_and_check():
        st = await s.sample.run_chat_load(
            s.engine, n_rooms=n_rooms, n_users=n_users, n_ticks=1,
            seed=len(points) + 1, subs=subs, verify=True, mirror=mirror)
        points.append(_oracle_exact(st["oracle"]))

    await publish_and_check()
    add_s, add_u = s.sample.build_membership(n_rooms, n_users, 0.5, seed=11)
    subs.subscribe_many(add_s, add_u)
    drop = subs.subscribers_of(3)
    subs.unsubscribe_many(np.full(len(drop) // 2, 3), drop[:len(drop) // 2])
    await publish_and_check()
    arena = s.engine.arena_for("ChatUserGrain")
    victims = rng.choice(n_users, n_users // 10, replace=False) \
        .astype(np.int64)
    arena.evict_keys(victims, write_back=True)
    mirror.evict_keys(victims)
    fresh = np.arange(n_users, n_users + len(victims), dtype=np.int64)
    arena.resolve_rows(fresh)
    await publish_and_check()
    rows, ok = arena.lookup_rows(fresh)
    recv = arena.state["received"]
    recv = recv.numpy() if s.port else np.asarray(recv)
    assert ok.all() and not recv[rows].any()   # reused rows are clean
    s.engine.config.stream_plane = False
    await publish_and_check()
    s.engine.config.stream_plane = True
    await publish_and_check()
    assert points == [True] * 5, points


_SCENARIOS = {
    "push_unbound": (_push_unbound, {}),
    "churn_rebuilds": (_churn_rebuilds, {}),
    "evicted_row_reuse": (_evicted_row_reuse, {}),
    "randomized_churn": (_randomized_churn, {"store": True}),
    "stale_pull_batch": (_stale_pull_batch, {"max_rounds_per_tick": 1}),
    "overflow_redelivery": (_overflow_redelivery, {}),
    "wide_stream_key": (_wide_stream_key, {}),
    "rollback_mutation_settled": (_rollback_mutation_settled, {
        "auto_fusion_ticks": 2, "auto_fusion_window": 2,
        "auto_fusion_verify_windows": 16}),
    "churn_points": (_churn_points, {"store": True, "attribution": True}),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_engine_twin_matches_jax(run, jax_trace_shim, name):
    """The device cases of tests/test_streams_plane.py (and the streams
    bench's churn exactness), each run through both packages: the same
    assertions hold on each side, and every column, use clock, engine
    counter and ``streams`` counter is equal."""
    scenario, cfg = _SCENARIOS[name]
    j, p = _twin(run, scenario, **cfg)
    if name == "overflow_redelivery":
        np.testing.assert_array_equal(p.ledger, j.ledger)
    if name == "rollback_mutation_settled":
        assert p.engine.autofuser.snapshot() == {
            k: j.engine.autofuser.snapshot()[k]
            for k in p.engine.autofuser.snapshot()}


def test_host_expand_and_batched_mutations_match_jax(run):
    j, p = types.SimpleNamespace(Subs=JaxSubscriptions), \
        types.SimpleNamespace(Subs=DeviceSubscriptions)
    run(_host_expand_and_mutations(j))
    run(_host_expand_and_mutations(p))
    assert p.out[0] == j.out[0] == 4
    np.testing.assert_array_equal(p.out[1], j.out[1])
    assert p.out[2] == j.out[2] == [20, 21] and p.out[3] == j.out[3] == []
    for a, b in zip(p.out[4], j.out[4]):
        np.testing.assert_array_equal(a, b)


def test_fused_chat_rebuilds_on_route_version(run, jax_trace_shim):
    """A fused window after a ``subscribe`` rebuilds (the port's cause
    ``stream_rebuild``; JAX re-traces, cause ``config_toggle``) and both
    deliver the same: every edge sees both windows but the new one, which
    sees only the second."""
    T = 4

    def stacked(s, base):
        return {"msg_id": s.dev(np.arange(T * 32, dtype=np.int32)
                                .reshape(T, 32) + base)}

    async def go(s):
        subs = _wire(s, 32, 800)
        rooms = np.arange(32, dtype=np.int64)
        prog = s.engine.fuse_ticks("ChatRoomGrain", "publish", rooms)
        prog.run(stacked(s, 0))
        assert prog.verify() == 0
        newbie = int(np.setdiff1d(np.arange(800), subs.subscribers_of(0))[0])
        subs.subscribe(0, newbie)
        prog.run(stacked(s, 1000))
        assert prog.verify() == 0
        exp = np.zeros(800, np.int64)
        np.add.at(exp, subs.host_expand(rooms)[0], 2 * T)
        exp[newbie] -= T
        np.testing.assert_array_equal(_user_received(s, 800)[0], exp)
        s.prog = prog

    j, p = _twin(run, go, auto_fusion_ticks=16)
    assert p.prog.rebuilds[CAUSE_STREAM_REBUILD] == 1


def test_plane_disabled_fused_window_never_verifies(run, jax_trace_shim):
    """With a route registered and the plane off, a fused window cannot
    run the host path: every routed source lane counts as a miss."""

    async def go(s):
        _wire(s, 16, 300)
        s.engine.config.stream_plane = False
        prog = s.engine.fuse_ticks("ChatRoomGrain", "publish",
                                   np.arange(16, dtype=np.int64))
        prog.run({"msg_id": s.dev(np.arange(4 * 16, dtype=np.int32)
                                  .reshape(4, 16))})
        s.misses = prog.verify()
        s.engine.config.stream_plane = True

    j, p = _twin(run, go, auto_fusion_ticks=16)
    assert p.misses == j.misses == 64


def test_subscriptions_carried_from_jax(run, jax_trace_shim):
    """``convert.subscriptions_from_jax`` carries the edge table, the
    buffered mutations and the bound key set: one publish on each side
    then delivers the same."""

    async def go(s, subs):
        s.engine.register_subscriptions("ChatRoomGrain", "publish", subs)
        s.engine.arena_for("ChatUserGrain").resolve_rows(
            np.arange(500, dtype=np.int64))
        inj = s.engine.make_injector("ChatRoomGrain", "publish",
                                     np.arange(16, dtype=np.int64))
        inj.inject({"msg_id": np.arange(16, dtype=np.int32) + 40})
        await s.engine.flush()

    j, p = _sides()
    jsubs = JaxSubscriptions(j.engine, "ChatUserGrain", "receive")
    streams, members = jax_streams.build_membership(16, 500, 2.0, seed=5)
    jsubs.subscribe_many(streams, members)
    jsubs.edges()                          # merged
    jsubs.subscribe_many([0, 1], [498, 499])
    jsubs.unsubscribe_many(streams[:3], members[:3])   # still buffered
    jsubs.bind(np.arange(16, dtype=np.int64))
    psubs = subscriptions_from_jax(jsubs, p.engine)
    run(go(j, jsubs))
    run(go(p, psubs))
    np.testing.assert_array_equal(psubs.edges(), jsubs.edges())
    _assert_twins(j, p)
    assert psubs.pull_deliveries == jsubs.pull_deliveries == 1


def test_caller_rewrites_after_handing_arrays_over(run):
    """The plane keeps copies: rewriting the arrays given to
    ``subscribe_many`` and ``bind`` changes nothing; a pull delivery that
    the round cap spills to the next tick carries the payload gathered at
    its publish, though the caller rewrites the injected tensor before
    that tick; a push-overflow check parked at a tick delivers the
    payload sent then, though the caller rewrites it before the drain."""

    async def go():
        e = TensorEngine(device="cpu", config=TensorEngineConfig(
            auto_fusion_ticks=0, max_rounds_per_tick=1))
        subs = DeviceSubscriptions(e, "ChatUserGrain", "receive")
        streams = torch.zeros(300, dtype=torch.int64)
        members = np.arange(300, dtype=np.int64)
        subs.subscribe_many(streams, members)
        streams += 3
        members[:] = 0
        e.register_subscriptions("ChatRoomGrain", "publish", subs)
        e.arena_for("ChatUserGrain").resolve_rows(
            np.arange(300, dtype=np.int64))
        bound = np.arange(2, dtype=np.int64)
        subs.bind(bound)
        bound[:] = bound[::-1].copy()
        inj = e.make_injector("ChatRoomGrain", "publish",
                              np.arange(2, dtype=np.int64))
        payload = torch.tensor([70, 71], dtype=torch.int32)
        inj.inject({"msg_id": payload})
        e.run_tick()   # the publish applies; its pull delivery spills
        assert e.queues[("ChatUserGrain", "receive")]
        payload.fill_(5_000)
        await e.flush()
        assert subs.pull_deliveries == 1
        # two publishes of stream 0 need 600 slots of a 512-wide CSR: the
        # second parks with a copy of its payload
        sent = torch.tensor([7, 8], dtype=torch.int32)
        e.send_batch("ChatRoomGrain", "publish",
                     torch.zeros(2, dtype=torch.int32), {"msg_id": sent})
        for _ in range(3):
            e.run_tick()
        sent.fill_(1_000)
        await e.flush()
        arena = e.arena_for("ChatUserGrain")
        rows, _ok = arena.lookup_rows(np.arange(300, dtype=np.int64))
        np.testing.assert_array_equal(subs.edges(), np.stack(
            [np.zeros(300, np.int64), np.arange(300)], axis=1))
        np.testing.assert_array_equal(arena.state["received"][rows], 3)
        np.testing.assert_array_equal(arena.state["last_msg"][rows], 70)
        mix = (np.array([70, 7, 8]) % 1009).sum()
        np.testing.assert_array_equal(arena.state["checksum"][rows], mix)
        assert subs.redeliveries >= 1

    run(go())


def test_bind_keeps_a_copy_where_jax_keeps_the_callers_array(
        run, jax_trace_shim):
    """A fault of the reference the port does not copy: JAX's ``bind``
    keeps the caller's key array and its digest, so a caller that
    rewrites the array in place leaves the digest matching the original
    key set while the pull layout lays its lanes out against the
    rewritten one — room 0's subscriber then receives room 1's message.
    The port binds a copy and delivers each room's message."""

    async def go(s):
        subs = s.Subs(s.engine, "ChatUserGrain", "receive")
        subs.subscribe_many([0, 1], [10, 11])
        s.engine.register_subscriptions("ChatRoomGrain", "publish", subs)
        s.engine.arena_for("ChatUserGrain").resolve_rows(
            np.array([10, 11], dtype=np.int64))
        bound = np.arange(2, dtype=np.int64)
        subs.bind(bound)
        bound[:] = [1, 0]
        inj = s.engine.make_injector("ChatRoomGrain", "publish",
                                     np.arange(2, dtype=np.int64))
        inj.inject({"msg_id": np.array([70, 71], np.int32)})
        await s.engine.flush()
        arena = s.engine.arena_for("ChatUserGrain")
        rows, _ok = arena.lookup_rows(np.array([10, 11], dtype=np.int64))
        col = arena.state["last_msg"]
        s.last = (col.numpy() if s.port else np.asarray(col))[rows].tolist()
        assert subs.pull_deliveries == 1

    j, p = _sides()
    run(go(j))
    run(go(p))
    assert j.last == [71, 70]
    assert p.last == [70, 71]
