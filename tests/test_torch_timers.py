"""Differential tests of the port's device timers plane against the JAX
package's (``orleans_tpu/tensor/timers_plane.py``).

Kernels: K14 ``timers_write`` and K15 ``timers_harvest`` (plain versions
on the CPU) against ``_write_kernel`` and ``_harvest_kernel`` on the same
seeded numpy inputs — pad lanes, stale and freed slots, one-shots,
periodic re-arms, dues and clocks at the int32 edges (where JAX's int32
arithmetic wraps and its division floors) and an empty harvest; all
exact.

Engines: twins of tests/test_timers_plane.py.  Each scenario runs once on
a JAX engine and once on a port engine (``device="cpu"``), asserting the
JAX test's own properties on both; then the timer mirrors (slot columns,
stamps, index, free slots, interned names), the device columns, the
plane's counters, the arena state by key and the engine's counters are
compared bit for bit.  Also here: the harvest's pad-width message count,
the fused-window starvation of the harvest (the reference's behaviour,
which the port keeps), the watchdog with collection on, and an engine
carried across from JAX mid-countdown (``convert``).

The installed JAX lacks ``jax.core.trace_state_clean``, which the JAX
attribution plane's eviction path calls: ``jax_trace_shim`` sets it per
test, as in tests/test_torch_attribution.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.auction  # noqa: F401 — registers the JAX AuctionGrain
import samples.watchdog  # noqa: F401 — registers the JAX FleetDeviceGrain
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.core.grain import batched_method as jax_batched_method
from orleans_tpu.tensor import MemoryVectorStore as JaxMemoryVectorStore
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import VectorGrain as JaxVectorGrain
from orleans_tpu.tensor import field as jax_field
from orleans_tpu.tensor import vector_grain as jax_vector_grain
from orleans_tpu.tensor.timers_plane import _harvest_kernel, _write_kernel
from orleans_tpu.tensor.vector_grain import (
    scatter_add_rows as jax_scatter_add_rows,
)
from orleans_tpu.tensor.vector_grain import scatter_rows as jax_scatter_rows

from orleans_tpu_torch.config import TensorEngineConfig
from orleans_tpu_torch.convert import (
    arena_state_from_numpy,
    store_from_jax,
    timers_from_jax,
)
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels.timers import (
    SENTINEL,
    timers_harvest,
    timers_harvest_plain,
    timers_write,
    timers_write_plain,
)
from orleans_tpu_torch.samples.auction import run_auction_load
from orleans_tpu_torch.samples.watchdog import run_watchdog_load
from orleans_tpu_torch.tensor import (
    TensorEngine,
    VectorGrain,
    field,
    scatter_add_rows,
    scatter_rows,
    vector_grain,
)
from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

IMIN, IMAX = -2**31, 2**31 - 1


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@jax_vector_grain
class TwinTimerGrain(JaxVectorGrain):
    """tests/test_timers_plane.py's TimerProbeGrain, in both packages:
    counts reminder deliveries per grain."""

    fires = jax_field(jnp.int32, 0)
    last_id = jax_field(jnp.int32, -1)

    @jax_batched_method
    @staticmethod
    def receive_reminder(state, batch, n_rows):
        ones = jnp.where(batch.mask, 1, 0).astype(jnp.int32)
        return {
            "fires": jax_scatter_add_rows(state["fires"], batch.rows, ones),
            "last_id": jax_scatter_rows(state["last_id"], batch.rows,
                                        batch.args["reminder_id"]),
        }

    @jax_batched_method
    @staticmethod
    def poke(state, batch, n_rows):
        return state


@vector_grain
class TwinTimerGrain(VectorGrain):  # noqa: F811 — the port twin
    fires = field(torch.int32, 0)
    last_id = field(torch.int32, -1)

    @batched_method
    @staticmethod
    def receive_reminder(state, batch, n_rows):
        ones = batch.mask.to(torch.int32)
        return {
            "fires": scatter_add_rows(state["fires"], batch.rows, ones),
            "last_id": scatter_rows(state["last_id"], batch.rows,
                                    batch.args["reminder_id"]),
        }

    @batched_method
    @staticmethod
    def poke(state, batch, n_rows):
        return state


# -- the kernels --------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _columns(rng, n):
    key = rng.integers(0, 1 << 20, n).astype(np.int32)
    key[0] = SENTINEL
    key[rng.random(n) < 0.2] = SENTINEL       # freed slots
    due = rng.integers(-50, 50, n).astype(np.int32)
    period = np.where(rng.random(n) < 0.5, 0,
                      rng.integers(1, 9, n)).astype(np.int32)
    name = rng.integers(0, 4, n).astype(np.int32)
    return key, due, period, name


def _edge_columns(n):
    """Dues, periods and clocks at the int32 edges: ``now - due`` and
    ``due + steps * period`` overflow int32 and wrap."""
    key = np.arange(n, dtype=np.int32)
    key[0] = SENTINEL
    due = np.array([0, IMIN + 1, IMIN + 1, -5, IMAX, IMAX - 3, 7, -2**30,
                    IMIN + 7, 0, IMAX, 5] * (n // 12 + 1))[:n].astype(
                        np.int32)
    period = np.array([0, 1, IMAX, 3, 7, IMAX, 2**30, 2**30 + 5, 1, IMAX,
                       0, 2] * (n // 12 + 1))[:n].astype(np.int32)
    name = (np.arange(n) % 5).astype(np.int32)
    return key, due, period, name


@pytest.mark.parametrize("now", [0, 9, IMAX, IMAX - 1, IMIN + 10, 2**30])
@pytest.mark.parametrize("make", ["random", "edges"])
def test_timers_harvest_matches_jax(make, now):
    """K15 (plain) against ``_harvest_kernel``: pow2-padded lanes
    targeting the dead slot 0, stale and freed slots, one-shots and
    re-arms, the int32 edges."""
    rng = np.random.default_rng(abs(now) % 1000)
    n = 64
    key, due, period, name = _columns(rng, n) if make == "random" \
        else _edge_columns(n)
    idx = rng.choice(np.arange(1, n), 37, replace=False).astype(np.int32)
    idx = np.concatenate([idx, np.zeros(64 - 37, np.int32)])  # pad lanes
    k2, d2, k, nm, fired = (np.asarray(x) for x in _harvest_kernel(
        jnp.asarray(key), jnp.asarray(due), jnp.asarray(period),
        jnp.asarray(name), jnp.asarray(idx), jnp.int32(now)))
    for fn in (timers_harvest, timers_harvest_plain):
        pkey, pdue = _t(key), _t(due)
        pk, pnm, pf = fn(pkey, pdue, _t(period), _t(name), _t(idx), now)
        np.testing.assert_array_equal(pkey.numpy(), k2)
        np.testing.assert_array_equal(pdue.numpy(), d2)
        np.testing.assert_array_equal(pk.numpy(), k)
        np.testing.assert_array_equal(pnm.numpy(), nm)
        np.testing.assert_array_equal(pf.numpy(), fired)
    assert not fired[37:].any()  # pads never fire


def test_timers_harvest_empty():
    """An empty harvest writes nothing and returns empty lanes."""
    key, due, period, name = _columns(np.random.default_rng(0), 16)
    pkey, pdue = _t(key), _t(due)
    k, nm, fired = timers_harvest(pkey, pdue, _t(period), _t(name),
                                  _t(np.empty(0)), 5)
    assert k.shape == nm.shape == fired.shape == (0,)
    np.testing.assert_array_equal(pkey.numpy(), key)
    np.testing.assert_array_equal(pdue.numpy(), due)


@pytest.mark.parametrize("w", [1, 13, 256])
def test_timers_write_matches_jax(w):
    """K14 (plain) against ``_write_kernel``: arm and cancel values at
    unique slots, pow2 pads targeting slot 0 with the sentinel values,
    an out-of-range slot dropped."""
    rng = np.random.default_rng(w)
    n = 512
    cols = [c.copy() for c in _columns(rng, n)]
    key, due, period, name = cols
    slots = rng.choice(np.arange(1, n), w, replace=False).astype(np.int32)
    m = 1 << max(0, w - 1).bit_length()
    idx = np.zeros(m, np.int32)
    idx[:w] = slots
    if w > 2:
        idx[1] = n + 3  # dropped
    k = np.full(m, SENTINEL, np.int32)
    k[:w] = rng.integers(0, 1 << 20, w)
    d = np.zeros(m, np.int32)
    d[:w] = rng.integers(IMIN + 1, IMAX, w)
    nm = np.zeros(m, np.int32)
    nm[:w] = rng.integers(0, 3, w)
    p = np.zeros(m, np.int32)
    p[:w] = rng.integers(0, IMAX, w)
    want = [np.asarray(x) for x in _write_kernel(
        *(jnp.asarray(c) for c in (key, due, name, period, idx, k, d, nm,
                                   p)))]
    for fn in (timers_write, timers_write_plain):
        got = [_t(c) for c in (key, due, name, period)]
        fn(*got, *(_t(c) for c in (idx, k, d, nm, p)))
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wnt)


# -- engine twins -------------------------------------------------------------

_SHARED = ("auto_fusion_ticks", "auto_fusion_window", "timers_catchup_jump",
           "collection_idle_ticks", "collection_every_ticks",
           "collection_pause_budget_s", "collection_chunk_rows")


def _sides(store=False, auto_fusion_ticks=0, **cfg):
    assert set(cfg) <= set(_SHARED), cfg
    jstore = JaxMemoryVectorStore() if store else None
    pstore = MemoryVectorStore() if store else None
    j = types.SimpleNamespace(
        engine=JaxTensorEngine(config=JaxEngineConfig(
            tick_interval=0.0, auto_fusion_ticks=auto_fusion_ticks, **cfg),
            store=jstore), store=jstore)
    p = types.SimpleNamespace(
        engine=TensorEngine(config=TensorEngineConfig(
            auto_fusion_ticks=auto_fusion_ticks, **cfg), store=pstore,
            device="cpu"), store=pstore)
    return j, p


def _activate(eng, keys):
    inj = eng.make_injector("TwinTimerGrain", "poke",
                            np.asarray(keys, np.int64))
    inj.inject({})
    eng.run_tick()


def _fires(eng, keys):
    arena = eng.arena_for("TwinTimerGrain")
    rows, found = arena.lookup_rows(np.asarray(keys, np.int64))
    col = arena.state["fires"]
    col = col.cpu().numpy() if isinstance(col, torch.Tensor) \
        else np.asarray(col)
    return np.where(found, col[rows], 0), found


def _assert_timers_twins(jt, pt):
    assert pt._names == jt._names
    assert set(pt._types) == set(jt._types)
    for name, a in jt._types.items():
        b = pt._types[name]
        assert b.cap == a.cap
        for attr in ("key_np", "due_np", "name_np", "period_np",
                     "stamp_np"):
            np.testing.assert_array_equal(getattr(b, attr),
                                          getattr(a, attr), err_msg=attr)
        assert b.index == a.index
        assert b.free == a.free
        for attr in ("key", "due", "name", "period"):
            if getattr(a, attr) is None:
                assert getattr(b, attr) is None
                continue
            np.testing.assert_array_equal(getattr(b, attr).cpu().numpy(),
                                          np.asarray(getattr(a, attr)),
                                          err_msg=attr)
    js, ps = jt.snapshot(), pt.snapshot()
    js.pop("harvest_seconds")
    ps.pop("harvest_seconds")
    assert ps == js


def _assert_state_by_key(je, pe, type_name):
    ja, pa = je.arena_for(type_name), pe.arena_for(type_name)
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(np.sort(pa.keys()), keys)
    jrows, _ = ja.lookup_rows(keys)
    prows, _ = pa.lookup_rows(keys)
    for name, col in ja.state.items():
        np.testing.assert_array_equal(pa.state[name].cpu().numpy()[prows],
                                      np.asarray(col)[jrows], err_msg=name)


def _assert_twins(j, p, type_name="TwinTimerGrain"):
    je, pe = j.engine, p.engine
    _assert_timers_twins(je.timers, pe.timers)
    _assert_state_by_key(je, pe, type_name)
    for attr in ("tick_number", "messages_processed", "activation_passes"):
        assert getattr(pe, attr) == getattr(je, attr), attr


def _twin(run, scenario, type_name="TwinTimerGrain", **kw):
    j, p = _sides(**kw)
    run(scenario(j))
    run(scenario(p))
    _assert_twins(j, p, type_name)
    return j, p


def test_one_shot_fires_exactly_once_on_exact_tick(run):
    async def go(s):
        eng = s.engine
        keys = np.arange(64, dtype=np.int64)
        _activate(eng, keys)
        due = eng.tick_number + 10
        eng.timers.arm_batch("TwinTimerGrain", keys,
                             np.full(64, due, np.int64), 0, "close")
        assert eng.timers.armed_total == 64
        while eng.tick_number < due - 1:
            eng.run_tick()
        await eng.flush()
        assert _fires(eng, keys)[0].sum() == 0, "fired before due"
        eng.run_tick()
        await eng.flush()
        assert (_fires(eng, keys)[0] == 1).all()
        for _ in range(10):
            eng.run_tick()
        await eng.flush()
        assert (_fires(eng, keys)[0] == 1).all(), "one-shot fired twice"
        assert eng.timers.armed_total == 0
        snap = eng.timers.snapshot()
        assert snap["fired"] == 64 and snap["worst_lateness_ticks"] == 0

    _twin(run, go)


def test_periodic_phase_preserved_and_cancel(run):
    async def go(s):
        eng = s.engine
        _activate(eng, [7])
        t0 = eng.tick_number
        eng.timers.arm("TwinTimerGrain", 7, "beat", t0 + 3, 4)
        horizon = t0 + 20
        while eng.tick_number < horizon:
            eng.run_tick()
        await eng.flush()
        want = len(range(t0 + 3, horizon + 1, 4))
        assert _fires(eng, [7])[0][0] == want
        assert eng.timers.snapshot()["re_armed"] >= want - 1
        assert eng.timers.cancel("TwinTimerGrain", 7, "beat")
        assert eng.timers.armed_total == 0
        for _ in range(8):
            eng.run_tick()
        await eng.flush()
        assert _fires(eng, [7])[0][0] == want, "cancelled timer fired"
        assert not eng.timers.cancel("TwinTimerGrain", 7, "beat")

    _twin(run, go)


def test_wheel_upper_level_horizon_exact(run):
    async def go(s):
        eng = s.engine
        _activate(eng, [1, 2])
        t0 = eng.tick_number
        eng.timers.arm("TwinTimerGrain", 1, "far", t0 + 300)
        eng.timers.arm("TwinTimerGrain", 2, "near", t0 + 5)
        fired_at = {}
        while eng.tick_number < t0 + 310:
            eng.run_tick()
            if (eng.tick_number - t0) in (5, 299, 300):
                await eng.flush()
                fired_at[eng.tick_number - t0] = \
                    _fires(eng, [1, 2])[0].tolist()
        assert fired_at == {5: [0, 1], 299: [0, 1], 300: [1, 1]}

    _twin(run, go)


def test_catchup_jump_rebuild_fires_all(run):
    async def go(s):
        eng = s.engine
        keys = np.arange(32, dtype=np.int64)
        _activate(eng, keys)
        dues = eng.tick_number + 5 + np.arange(32, dtype=np.int64) * 7
        eng.timers.arm_batch("TwinTimerGrain", keys, dues, 0, "jump")
        eng.tick_number += 500
        eng.run_tick()
        await eng.flush()
        assert (_fires(eng, keys)[0] == 1).all()
        assert eng.timers.armed_total == 0

    _twin(run, go, timers_catchup_jump=64)


def test_evict_reactivate_fires_once_on_time(run, jax_trace_shim):
    async def go(s):
        eng = s.engine
        keys = np.arange(16, dtype=np.int64)
        _activate(eng, keys)
        due = eng.tick_number + 12
        eng.timers.arm_batch("TwinTimerGrain", keys,
                             np.full(16, due, np.int64), 0, "wake")
        for _ in range(3):
            eng.run_tick()
        arena = eng.arena_for("TwinTimerGrain")
        assert arena.evict_keys(keys, write_back=True) == 16
        assert eng.timers.armed_total == 16
        while eng.tick_number < due:
            eng.run_tick()
        await eng.flush()
        f, found = _fires(eng, keys)
        assert found.all() and (f == 1).all()
        for _ in range(5):
            eng.run_tick()
        await eng.flush()
        assert (_fires(eng, keys)[0] == 1).all()

    _twin(run, go, store=True)


def test_auction_sample_closes_exactly(run):
    from samples.auction import run_auction_load as jax_run_auction_load

    j, p = _sides()
    js = run(jax_run_auction_load(j.engine, n_auctions=512, n_ticks=24))
    ps = run(run_auction_load(p.engine, n_auctions=512, n_ticks=24))
    assert ps == js and ps["exact"] and ps["closed"] == 512
    _assert_twins(j, p, "AuctionGrain")


def test_watchdog_sample_flags_exactly(run):
    from samples.watchdog import run_watchdog_load as jax_run_watchdog_load

    j, p = _sides()
    js = run(jax_run_watchdog_load(j.engine, n_devices=512, window=6,
                                   n_windows=3))
    ps = run(run_watchdog_load(p.engine, n_devices=512, window=6,
                               n_windows=3))
    assert ps == js and ps["exact"]
    assert ps["flagged_dead"] == ps["silent"] > 0
    _assert_twins(j, p, "FleetDeviceGrain")


# -- the harvest's contracts --------------------------------------------------

def test_harvest_pad_lanes_count_as_messages(run):
    """A harvest of 3 due timers runs one ``receive_reminder`` batch at
    the pow2-padded width 4, and the JAX engine counts the whole width
    in ``messages_processed``, the masked pad lane included; the port
    pads the same way and counts the same."""

    async def go(s):
        eng = s.engine
        _activate(eng, [1, 2, 3])
        eng.timers.arm_batch("TwinTimerGrain", np.array([1, 2, 3]),
                             np.full(3, eng.tick_number + 2), 0, "pad")
        eng.run_tick()
        before = eng.messages_processed
        eng.run_tick()  # the due tick: harvest width 3, padded to 4
        await eng.flush()
        s.counted = eng.messages_processed - before
        assert (_fires(eng, [1, 2, 3])[0] == 1).all()

    j, p = _twin(run, go)
    assert j.counted == p.counted == 4


async def _watchdog_until_fused(s, n, window):
    """The watchdog heartbeating every tick (a steady pattern the
    auto-fuser fuses: a fresh payload leaf per tick) with a watch due
    while windows run.  Records the harvested fires after every tick."""
    eng = s.engine
    keys = np.arange(n, dtype=np.int64)
    inj = eng.make_injector("FleetDeviceGrain", "heartbeat", keys)
    inj.inject({"beat": np.ones(n, np.int32)})
    eng.run_tick()
    await eng.flush()
    t0 = eng.tick_number
    eng.timers.arm_batch("FleetDeviceGrain", keys,
                         np.full(n, t0 + window, np.int64), window, "watch")
    s.fired_by_tick = []
    for _ in range(4 * window):
        inj.inject({"beat": np.ones(n, np.int32)})
        eng.run_tick()
        s.fired_by_tick.append((eng.tick_number, eng.timers.fired_total))
    await eng.flush()
    s.fused = eng.autofuser.snapshot()["ticks_fused"]


def test_fused_windows_starve_the_harvest_as_in_jax(run, jax_trace_shim):
    """The JAX auto-fuser consumes ticks without running the harvest
    (``offer`` skips ``advance_to``): a watch due inside a fused stretch
    fires at the next unfused tick, late, and the lateness shows in
    ``worst_lateness_ticks``.  The port does the same, tick for tick."""
    j, p = _twin(run, lambda s: _watchdog_until_fused(s, 64, 8),
                 type_name="FleetDeviceGrain", auto_fusion_ticks=4,
                 auto_fusion_window=4)
    assert j.fused > 0 and p.fused == j.fused
    assert p.fired_by_tick == j.fired_by_tick
    # 4 watches were due in the 32 ticks; 2 harvests ran, the first 23
    # ticks late (missed periods coalesce into one fire)
    snap = p.engine.timers.snapshot()
    assert snap["harvests"] == 2 and snap["fired"] == 128
    assert snap["worst_lateness_ticks"] == 23


def test_watchdog_with_collection_matches_jax(run, jax_trace_shim):
    """The watchdog with collection on: silent devices are evicted between
    watches and each watch fire re-activates them through the store.  The
    fires to evicted devices miss and park; their redeliveries drain
    together at the final flush and apply in one round, each reading the
    same re-activated state, so a silent device counts one death per
    parked watch (3, where ``run_watchdog_load``'s oracle says 1).  The
    port is held to the JAX engine's output, not to that oracle."""
    from samples.watchdog import run_watchdog_load as jax_run_watchdog_load

    kw = dict(store=True, collection_idle_ticks=4, collection_every_ticks=2)
    j, p = _sides(**kw)
    js = run(jax_run_watchdog_load(j.engine, n_devices=512, window=8,
                                   n_windows=4, verify=False))
    ps = run(run_watchdog_load(p.engine, n_devices=512, window=8,
                               n_windows=4, verify=False))
    assert ps == js and not ps["exact"]
    assert p.engine.stats()["evicted"] == j.engine.snapshot()["evicted"] > 0
    assert p.engine.stats()["restored"] == j.engine.snapshot()["restored"]
    _assert_twins(j, p, "FleetDeviceGrain")
    arena = p.engine.arena_for("FleetDeviceGrain")
    dead = int(arena._key_of_row[np.flatnonzero(
        arena.state["alive"].numpy() == 0)[0]])
    row = arena.read_row(dead)
    assert int(row["deaths"]) == 3 and int(row["checks"]) == 4


def test_timers_and_store_carried_from_jax(run, jax_trace_shim):
    """An engine carried across from JAX mid-countdown — evicted rows in
    the store, a free list, periodic and one-shot timers armed — then 20
    more ticks on both: the same fires, the same state."""
    j, p = _sides(store=True)
    je, pe = j.engine, p.engine
    keys = np.arange(40, dtype=np.int64)

    async def setup():
        _activate(je, keys)
        t0 = je.tick_number
        je.timers.arm_batch("TwinTimerGrain", keys[:20],
                            np.full(20, t0 + 3), 5, "beat")
        je.timers.arm_batch("TwinTimerGrain", keys[20:],
                            t0 + 2 + keys[20:] % 7, 0, "once")
        for _ in range(6):
            je.run_tick()
        await je.flush()
        ja = je.arena_for("TwinTimerGrain")
        assert ja.evict_keys(keys[::3]) == len(keys[::3])

    run(setup())
    ja = je.arena_for("TwinTimerGrain")
    pa = pe.arena_for("TwinTimerGrain")
    p.store._store.update(store_from_jax(j.store)._store)
    arena_state_from_numpy(
        pa, ja._key_of_row, {k: np.asarray(v) for k, v in ja.state.items()},
        free_rows=ja._free[0], shard_next=int(ja._shard_next[0]),
        last_use_tick=ja.last_use_tick,
        last_use_dev=np.asarray(ja.last_use_dev),
        eviction_epoch=ja.eviction_epoch, evicted_count=ja.evicted_count,
        restored_count=ja.restored_count)
    pe.tick_number = je.tick_number
    pe.messages_processed = je.messages_processed
    pe.activation_passes = je.activation_passes
    timers_from_jax(pe.timers, je.timers)
    _assert_timers_twins(je.timers, pe.timers)

    async def more(eng):
        for _ in range(20):
            eng.run_tick()
        await eng.flush()

    run(more(je))
    run(more(pe))
    _assert_twins(j, p)
    np.testing.assert_array_equal(pa._free[0], ja._free[0])
    assert pa.restored_count == ja.restored_count > 0
