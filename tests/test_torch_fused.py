"""Differential tests of the port's steady-state tick against the JAX package.

The same seeded loads go through ``orleans_tpu`` (JAX on the CPU, with the
latency ledger and auto-fusion on and workload attribution off) and
through ``orleans_tpu_torch`` on ``device="cpu"`` with attribution off too
(tests/test_torch_attribution.py holds the plane against JAX's), where a
fused window runs its ticks eagerly with every kernel's plain version (on
the card the same ticks replay as a CUDA graph;
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold that against these
results).  Arenas are compared BY KEY: integer columns, message counts,
auto-fusion counters and the ledger histogram exactly; the float fan-in
within twice Higham's bound for recursive summation,
``2 * (k - 1) * 2**-24 * sum|x|`` over the ``k`` summed terms (``k`` is
the game's ``updates``; every score is positive, so ``sum|x|`` is the
total).  The scenarios mirror tests/test_fused.py and
tests/test_autofuse.py.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.core.grain import batched_method as jax_batched_method
from orleans_tpu.tensor import Batch as JaxBatch
from orleans_tpu.tensor import Emit as JaxEmit
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import VectorGrain as JaxVectorGrain
from orleans_tpu.tensor import field as jax_field
from orleans_tpu.tensor import vector_grain as jax_vector_grain
from orleans_tpu.tensor.fused import FusedTickProgram as JaxFusedTickProgram
from orleans_tpu.tensor.vector_grain import (
    scatter_add_rows as jax_scatter_add_rows,
    scatter_rows as jax_scatter_rows,
)
from samples.presence import run_presence_load as jax_run_presence_load
from samples.presence import (
    run_presence_load_fused as jax_run_presence_load_fused,
)

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.convert import ledger_state_from_numpy
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.samples.presence import (
    run_presence_load,
    run_presence_load_fused,
)
from orleans_tpu_torch.tensor import (
    Batch,
    Emit,
    TensorEngine,
    VectorGrain,
    field,
    scatter_add_rows,
    scatter_rows,
    vector_grain,
)
from orleans_tpu_torch.tensor.fused import (
    CAUSE_GENERATION_REPACK,
    FusedTickProgram,
)


# -- twin grains (tests/test_autofuse.py's LwwGrain / HopGrain) ---------------

@jax_vector_grain
class TwinLwwGrain(JaxVectorGrain):
    """Last-writer-wins register + delivery counter: ``value`` exposes
    application ORDER, ``count`` delivery EXACTNESS."""

    value = jax_field(jnp.int32, 0)
    count = jax_field(jnp.int32, 0)

    @jax_batched_method
    @staticmethod
    def put(state, batch: JaxBatch, n_rows: int):
        ones = jnp.ones_like(batch.rows, dtype=jnp.int32) * batch.mask
        v = jnp.broadcast_to(jnp.asarray(batch.args["v"], jnp.int32),
                             batch.rows.shape)
        return {
            **state,
            "value": jax_scatter_rows(state["value"], batch.rows, v),
            "count": jax_scatter_add_rows(state["count"], batch.rows, ones),
        }


@jax_vector_grain
class TwinHopGrain(JaxVectorGrain):
    """Emits to a per-tick destination, to steer emits at cold keys."""

    sent = jax_field(jnp.int32, 0)

    @jax_batched_method
    @staticmethod
    def send(state, batch: JaxBatch, n_rows: int):
        ones = jnp.ones_like(batch.rows, dtype=jnp.int32) * batch.mask
        state = {**state,
                 "sent": jax_scatter_add_rows(state["sent"], batch.rows,
                                              ones)}
        emit = JaxEmit(interface="TwinLwwGrain", method="put",
                       keys=batch.args["dst"], args={"v": batch.args["v"]},
                       mask=batch.mask)
        return state, None, (emit,)


@vector_grain
class TwinLwwGrain(VectorGrain):  # noqa: F811 — the port twin
    value = field(torch.int32, 0)
    count = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def put(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows) * batch.mask
        v = batch.args["v"].expand(batch.rows.shape).contiguous()
        return {
            **state,
            "value": scatter_rows(state["value"], batch.rows, v),
            "count": scatter_add_rows(state["count"], batch.rows, ones),
        }


@vector_grain
class TwinHopGrain(VectorGrain):  # noqa: F811 — the port twin
    sent = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def send(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows) * batch.mask
        state = {**state,
                 "sent": scatter_add_rows(state["sent"], batch.rows, ones)}
        emit = Emit(interface="TwinLwwGrain", method="put",
                    keys=batch.args["dst"], args={"v": batch.args["v"]},
                    mask=batch.mask)
        return state, None, (emit,)


# -- engines and comparisons --------------------------------------------------

def _engines(initial_capacity: int = 1024, **cfg):
    """A JAX engine and a port engine with the same config: auto-fusion
    per ``cfg``, the ledger on, the attribution plane off on both."""
    jax_cfg = JaxEngineConfig(tick_interval=0.0, **cfg)
    je = JaxTensorEngine(config=jax_cfg,
                         metrics=JaxMetricsConfig(attribution_enabled=False),
                         initial_capacity=initial_capacity)
    pe = TensorEngine(device="cpu", initial_capacity=initial_capacity,
                      config=TensorEngineConfig(**cfg),
                      metrics=MetricsConfig(attribution_enabled=False))
    return je, pe


def _fuse_cfg(**kw):
    base = dict(auto_fusion_ticks=3, auto_fusion_window=4)
    base.update(kw)
    return base


def _assert_arena_matches(je, pe, type_name, float_count=None):
    ja, pa = je.arena_for(type_name), pe.arena_for(type_name)
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(keys, np.sort(pa.keys()))
    jrows, jfound = ja.lookup_rows(keys)
    prows, pfound = pa.lookup_rows(keys)
    assert jfound.all() and pfound.all()
    for name, col in ja.state.items():
        want = np.asarray(col)[jrows]
        got = pa.state[name].numpy()[prows]
        assert got.dtype == want.dtype, name
        if want.dtype.kind == "f":
            k = np.asarray(ja.state[float_count])[jrows]
            tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * np.abs(want)
            assert np.all(np.abs(got - want) <= tol), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_presence_matches(je, pe):
    _assert_arena_matches(je, pe, "PresenceGrain")
    _assert_arena_matches(je, pe, "GameGrain", float_count="updates")


def _assert_ledger_matches(je, pe):
    want, got = je.ledger.snapshot(), pe.ledger.snapshot()
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name]["counts"] == w["counts"], name
        assert got[name]["total"] == w["total"], name


def _assert_counters_match(je, pe):
    assert pe.messages_processed == je.messages_processed
    assert pe.tick_number == je.tick_number
    assert pe.autofuser.snapshot() == je.autofuser.snapshot()


async def _drive_hop(engine, n, ticks, dst_of):
    """tests/test_autofuse.py's HopGrain loop: one inject per tick."""
    src = np.arange(n, dtype=np.int64)
    inj = engine.make_injector("TwinHopGrain", "send", src)
    for t in range(ticks):
        inj.inject({"dst": np.full(n, dst_of(t), np.int32),
                    "v": np.full(n, t + 1, np.int32)})
        await engine.drain_queues()
    await engine.flush()


def _lww(engine, keys):
    arena = engine.arena_for("TwinLwwGrain")
    rows = arena.resolve_rows(np.asarray(keys, dtype=np.int64))
    state = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in arena.state.items()}
    return state["value"][rows], state["count"][rows]


# -- tests/test_fused.py twins ------------------------------------------------

def test_fused_presence_equals_unfused(run):
    """The manual fused loader: the fused arenas equal JAX's fused arenas,
    and per tick they match the port's own unfused run."""
    n_players, n_games, T = 2000, 20, 6

    async def main():
        je, pe = _engines(auto_fusion_ticks=0)
        jstats = await jax_run_presence_load_fused(
            je, n_players=n_players, n_games=n_games, n_ticks=T, window=3)
        pstats = await run_presence_load_fused(
            pe, n_players=n_players, n_games=n_games, n_ticks=T, window=3)
        plain = TensorEngine(device="cpu", config=TensorEngineConfig(
            auto_fusion_ticks=0))
        await run_presence_load(plain, n_players=n_players, n_games=n_games,
                                n_ticks=T)
        return je, jstats, pe, pstats, plain

    je, jstats, pe, pstats, plain = run(main())
    assert pstats["engine"] == jstats["engine"] == "fused"
    assert pstats["ticks"] == jstats["ticks"]
    _assert_presence_matches(je, pe)
    _assert_ledger_matches(je, pe)
    assert pe.messages_processed == je.messages_processed
    # per tick, fused == unfused (one extra warm window of 3 ticks)
    keys = np.arange(n_games, dtype=np.int64)
    upd_plain, upd_fused = (
        a.state["updates"].numpy()[a.lookup_rows(keys)[0]]
        for a in (plain.arena_for("GameGrain"), pe.arena_for("GameGrain")))
    np.testing.assert_array_equal(upd_fused * T, upd_plain * (T + 3))
    assert upd_plain.sum() == n_players * T


def test_fused_miss_counter_detects_cold_grains(run):
    """Emits to never-activated games surface as the same nonzero miss
    count in both packages — the exactness guard, not corruption."""

    async def main():
        import samples.presence  # noqa: F401 — registers the JAX types

        je, pe = _engines(auto_fusion_ticks=0)
        players = np.arange(50, dtype=np.int64)
        counts = []
        for engine, prog_of, ticks, static in (
                (je, je.fuse_ticks, {"tick": jnp.arange(1, 3,
                                                        dtype=jnp.int32)},
                 {"game": jnp.full(50, 7, jnp.int32),
                  "score": jnp.ones(50, jnp.float32)}),
                (pe, pe.fuse_ticks, {"tick": torch.arange(
                    1, 3, dtype=torch.int32)},
                 {"game": torch.full((50,), 7, dtype=torch.int32),
                  "score": torch.ones(50)})):
            engine.arena_for("PresenceGrain").resolve_rows(players)
            prog = prog_of("PresenceGrain", "heartbeat", players)
            prog.run(ticks, static_args=static)
            counts.append(prog.verify())
        return counts, je, pe

    (jmiss, pmiss), je, pe = run(main())
    assert pmiss == jmiss > 0
    assert pe.messages_processed == je.messages_processed


def test_fused_rebuilds_after_arena_growth(run):
    """Arena growth between windows (a generation bump) rebuilds the
    program against the new columns and mirrors."""

    async def main():
        import samples.presence  # noqa: F401

        out = []
        je, pe = _engines(initial_capacity=64, auto_fusion_ticks=0)
        players = np.arange(32, dtype=np.int64)
        for engine, arange, static in (
                (je, lambda a, b: jnp.arange(a, b, dtype=jnp.int32),
                 {"game": jnp.zeros(32, jnp.int32),
                  "score": jnp.ones(32, jnp.float32)}),
                (pe, lambda a, b: torch.arange(a, b, dtype=torch.int32),
                 {"game": torch.zeros(32, dtype=torch.int32),
                  "score": torch.ones(32)})):
            engine.arena_for("PresenceGrain").resolve_rows(players)
            engine.arena_for("GameGrain").resolve_rows(
                np.arange(4, dtype=np.int64))
            prog = engine.fuse_ticks("PresenceGrain", "heartbeat", players)
            prog.run({"tick": arange(1, 3)}, static_args=static)
            assert prog.verify() == 0
            gen = engine.arena_for("PresenceGrain").generation
            engine.arena_for("PresenceGrain").resolve_rows(
                np.arange(100, 400, dtype=np.int64))  # grows
            assert engine.arena_for("PresenceGrain").generation != gen
            prog.run({"tick": arange(3, 5)}, static_args=static)
            assert prog.verify() == 0
            out.append(prog)
        return je, pe, out[1]

    je, pe, prog = run(main())
    assert prog.rebuilds[CAUSE_GENERATION_REPACK] == 1
    arena = pe.arena_for("PresenceGrain")
    rows = arena.resolve_rows(np.arange(32, dtype=np.int64))
    np.testing.assert_array_equal(arena.state["heartbeats"].numpy()[rows], 4)
    _assert_presence_matches(je, pe)
    _assert_ledger_matches(je, pe)


def test_fused_replay_stacked_sources_match_jax(run):
    """FusedTickProgram.replay: per-tick key sets ride as ``__rows__`` /
    ``__mask__`` leaves; absent lanes are exact no-ops."""
    rng = np.random.default_rng(4)
    T, m = 3, 24
    keys2d = rng.integers(0, 40, (T, m)).astype(np.int64)
    mask2d = rng.random((T, m)) < 0.7

    async def main():
        je, pe = _engines(auto_fusion_ticks=0)
        v = (np.arange(T * m, dtype=np.int32) % 11).reshape(T, m)
        jprog = JaxFusedTickProgram.replay(
            je, [("TwinLwwGrain", "put", keys2d, mask2d)])
        jrows = jnp.asarray(jprog.sources[0].rows2d.astype(np.int32))
        jprog.run({"__rows__": jrows, "__mask__": jnp.asarray(mask2d),
                   "v": jnp.asarray(v)})
        pprog = FusedTickProgram.replay(
            pe, [("TwinLwwGrain", "put", keys2d, mask2d)])
        pprog.run({"__rows__": pprog.sources[0].rows2d,
                   "__mask__": mask2d, "v": v})
        return je, jprog.verify(), pe, pprog.verify()

    je, jmiss, pe, pmiss = run(main())
    assert pmiss == jmiss == 0
    _assert_arena_matches(je, pe, "TwinLwwGrain")
    assert pe.messages_processed == je.messages_processed


# -- tests/test_autofuse.py twins ---------------------------------------------

def test_presence_autofuses_with_inject_only_loader(run):
    """The inject-only Presence loader engages auto-fusion in both
    packages; the arenas, counters and latency histograms agree."""
    kw = dict(n_players=2000, n_games=20, n_ticks=16)

    async def main():
        je, pe = _engines(**_fuse_cfg(auto_fusion_ticks=4))
        jstats = await jax_run_presence_load(je, **kw)
        pstats = await run_presence_load(pe, **kw)
        return je, jstats, pe, pstats

    je, jstats, pe, pstats = run(main())
    assert pstats["autofuse"]["windows_run"] > 0
    assert pstats["autofuse"]["ticks_fused"] > 0
    assert pstats["autofuse"] == jstats["autofuse"]
    _assert_counters_match(je, pe)
    assert pe.activation_passes == je.activation_passes
    _assert_presence_matches(je, pe)
    _assert_ledger_matches(je, pe)
    assert pe.stats()["latency_ledger"]["records"] > 0
    assert pe.stats()["autofuse"] == pstats["autofuse"]
    # the window stamps its arenas as used (the JAX engine stamps
    # last_use_tick of every live row)
    for type_name in ("PresenceGrain", "GameGrain"):
        ja, pa = je.arena_for(type_name), pe.arena_for(type_name)
        keys = np.sort(ja.keys())
        np.testing.assert_array_equal(
            pa.last_use(pa.lookup_rows(keys)[0]),
            ja.last_use_tick[ja.lookup_rows(keys)[0]])


def test_rollback_replays_exactly_on_cold_destination(run):
    """A window whose emits reach an unactivated key rolls back and
    replays unfused: counts stay exact, the cold key activates."""
    n, T, cold_tick = 32, 24, 18

    async def main():
        je, pe = _engines(**_fuse_cfg(auto_fusion_max_rollbacks=100))
        for engine in (je, pe):
            engine.arena_for("TwinHopGrain").reserve(n)
            engine.arena_for("TwinLwwGrain").reserve(n + 64)
            await _drive_hop(engine, n, T,
                             lambda t: 5000 if t == cold_tick else 0)
        return je, pe

    je, pe = run(main())
    af = pe.autofuser
    assert af.windows_run > 0 and af.windows_rolled_back >= 1
    _assert_counters_match(je, pe)
    _assert_arena_matches(je, pe, "TwinHopGrain")
    _assert_arena_matches(je, pe, "TwinLwwGrain")
    _assert_ledger_matches(je, pe)
    _, count0 = _lww(pe, [0])
    _, countc = _lww(pe, [5000])
    assert int(count0[0]) == n * (T - 1) and int(countc[0]) == n


def test_window_rebuilds_after_cold_destination_activates(run):
    """From tick 18 on every emit goes to a key no one activated.  The
    first window rolls back and its replay activates the key; the port's
    window then rebuilds against the new directory mirror and fuses the
    rest exactly.  (The JAX window keeps the mirror it was traced with,
    since only a generation or epoch change re-traces it, so there every
    later window misses the key and rolls back too — ROADMAP queue C.)
    Both leave the same arenas."""
    n, T = 32, 64

    async def main():
        je, pe = _engines(**_fuse_cfg(auto_fusion_max_rollbacks=100))
        for engine in (je, pe):
            engine.arena_for("TwinHopGrain").reserve(n)
            engine.arena_for("TwinLwwGrain").reserve(n + 64)
            await _drive_hop(engine, n, T, lambda t: 0 if t < 18 else 5000)
        return je, pe

    je, pe = run(main())
    af = pe.autofuser.snapshot()
    assert af["windows_rolled_back"] == 1 and af["ticks_fused"] == 40
    assert pe.autofuser._program.rebuilds["mirror_rebuild"] == 1
    _assert_arena_matches(je, pe, "TwinHopGrain")
    _assert_arena_matches(je, pe, "TwinLwwGrain")
    # the ledger counts every message once in both; the port's fused
    # ticks land at delta 0 where the JAX replays land at delta 1
    want, got = je.ledger.snapshot(), pe.ledger.snapshot()
    assert {k: v["total"] for k, v in got.items()} \
        == {k: v["total"] for k, v in want.items()}
    assert got["TwinHopGrain.send"]["counts"][0] == n * 40
    assert pe.messages_processed == je.messages_processed
    _, count = _lww(pe, [0, 5000])
    np.testing.assert_array_equal(count, [n * 18, n * (T - 18)])


def test_pattern_break_replays_buffer_before_breaking_tick(run):
    """Buffered window ticks apply BEFORE the tick that broke the
    pattern — the breaking write wins the last-writer-wins register."""
    n = 16
    keys = np.arange(n, dtype=np.int64)

    async def main():
        je, pe = _engines(**_fuse_cfg(auto_fusion_window=8))
        for engine in (je, pe):
            inj = engine.make_injector("TwinLwwGrain", "put", keys)
            for t in range(8):
                inj.inject({"v": np.full(n, t + 1, np.int32)})
                await engine.drain_queues()
            assert engine.autofuser.has_buffer()
            engine.send_batch("TwinLwwGrain", "put", keys.copy(),
                              {"v": np.full(n, 99, np.int32)})
            await engine.drain_queues()
            await engine.flush()
        return je, pe

    je, pe = run(main())
    value, count = _lww(pe, keys)
    np.testing.assert_array_equal(count, 9)
    np.testing.assert_array_equal(value, 99)
    _assert_counters_match(je, pe)
    _assert_arena_matches(je, pe, "TwinLwwGrain")
    _assert_ledger_matches(je, pe)


@pytest.mark.parametrize("refresh", ["every_tick", "mid_window"])
def test_payload_refreshed_in_place_matches_unfused(run, refresh):
    """A loader that reuses one payload tensor per leaf and refreshes it in
    place each tick (``buf.copy_(next)``) gets the unfused result: the
    buffered ticks keep their own values.  ``every_tick``: both leaves
    change every tick, so both are per-tick.  ``mid_window``: ``dst`` is
    static until tick 8 and is then rewritten in place, which breaks the
    pattern at that tick.  A tick counter rides along as a fresh scalar,
    as Presence's does.  The JAX engine gets fresh arrays instead."""
    n, T = 16, 24
    src = np.arange(n, dtype=np.int64)

    def dst_of(t):
        return 100 + t % 3 if refresh == "every_tick" else 100 + (t >= 8)

    async def drive(engine, reuse):
        engine.arena_for("TwinHopGrain").reserve(n)
        engine.arena_for("TwinLwwGrain").resolve_rows(
            np.arange(100, 103, dtype=np.int64))  # every destination warm
        inj = engine.make_injector("TwinHopGrain", "send", src)
        dst_buf = torch.empty(n, dtype=torch.int32)
        v_buf = torch.empty(n, dtype=torch.int32)
        dst_np = None
        for t in range(T):
            dst = np.full(n, dst_of(t), np.int32)
            v = np.full(n, t + 1, np.int32)
            if reuse:
                if t == 0 or dst_of(t) != dst_of(t - 1):
                    dst_buf.copy_(torch.from_numpy(dst))
                v_buf.copy_(torch.from_numpy(v))
                inj.inject({"dst": dst_buf, "v": v_buf, "t": np.int32(t)})
            else:
                # JAX: a changed value is a new array, an unchanged one
                # the same array (a static leaf)
                if dst_np is None or dst_np[0] != dst[0]:
                    dst_np = dst
                inj.inject({"dst": dst_np, "v": v, "t": np.int32(t)})
            await engine.drain_queues()
        await engine.flush()

    async def main():
        je, pe = _engines(**_fuse_cfg())
        plain = TensorEngine(device="cpu", config=TensorEngineConfig(
            auto_fusion_ticks=0))
        await drive(je, reuse=False)
        await drive(pe, reuse=True)
        await drive(plain, reuse=True)
        return je, pe, plain

    je, pe, plain = run(main())
    af = pe.autofuser.snapshot()
    assert af["windows_run"] > 0 and af["windows_rolled_back"] == 0
    _assert_counters_match(je, pe)
    _assert_ledger_matches(je, pe)
    for name in ("TwinHopGrain", "TwinLwwGrain"):
        _assert_arena_matches(je, pe, name)
        _assert_arena_matches(plain, pe, name)
    value, count = _lww(pe, [100, 101, 102])
    want = np.bincount([dst_of(t) - 100 for t in range(T)], minlength=3)
    np.testing.assert_array_equal(count, n * want)
    last = [max((t + 1 for t in range(T) if dst_of(t) == d), default=0)
            for d in (100, 101, 102)]
    np.testing.assert_array_equal(value, last)


def test_rollback_hysteresis_bans_thrashing_pattern(run):
    """A pattern that rolls back auto_fusion_max_rollbacks times is
    banned; delivery stays exact throughout."""
    n, T, W = 32, 64, 4

    async def main():
        je, pe = _engines(**_fuse_cfg(auto_fusion_max_rollbacks=2,
                                      auto_fusion_window=W))
        for engine in (je, pe):
            engine.arena_for("TwinHopGrain").reserve(n)
            engine.arena_for("TwinLwwGrain").reserve(4096)
            await _drive_hop(engine, n, T, lambda t: 100 + t // W)
        return je, pe

    je, pe = run(main())
    af = pe.autofuser
    assert af.windows_rolled_back == 2
    assert af._disabled, "thrashing signature was not banned"
    _assert_counters_match(je, pe)
    _assert_arena_matches(je, pe, "TwinHopGrain")
    _assert_arena_matches(je, pe, "TwinLwwGrain")
    _assert_ledger_matches(je, pe)
    total = sum(int(_lww(pe, [100 + w])[1][0]) for w in range(T // W))
    assert total == n * T


def test_idle_flush_drains_partial_window(run):
    """With the engine loop running, a partial window drains by itself
    after the idle grace — no explicit flush()."""
    n, T = 16, 8
    keys = np.arange(n, dtype=np.int64)

    async def drive(engine):
        engine.start()
        try:
            inj = engine.make_injector("TwinLwwGrain", "put", keys)
            for t in range(T):
                inj.inject({"v": np.full(n, t + 1, np.int32)})
                await asyncio.sleep(0.005)
            deadline = asyncio.get_running_loop().time() + 5.0
            while asyncio.get_running_loop().time() < deadline:
                if (_lww(engine, keys)[1] == T).all():
                    break
                await asyncio.sleep(0.02)
            assert not engine.autofuser.has_buffer()
        finally:
            await engine.stop()
        return _lww(engine, keys)

    async def main():
        cfg = _fuse_cfg(auto_fusion_window=16, auto_fusion_idle_flush=0.05)
        pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg),
                          metrics=MetricsConfig(attribution_enabled=False))
        je = JaxTensorEngine(
            config=JaxEngineConfig(tick_interval=0.001, **cfg),
            metrics=JaxMetricsConfig(attribution_enabled=False))
        return await drive(je), await drive(pe), je, pe

    (jv, jc), (pv, pc), je, pe = run(main())
    np.testing.assert_array_equal(pc, T)
    np.testing.assert_array_equal(pv, T)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pv, jv)
    assert pe.messages_processed == je.messages_processed == n * T


# -- the ledger carried across ------------------------------------------------

def test_ledger_carried_across_matches_jax(run):
    """convert.ledger_state_from_numpy loads the JAX engine's ledger
    (host mirror and device histogram): the port reports the same
    histogram, and later records add to it."""

    async def main():
        je, pe = _engines(auto_fusion_ticks=0)
        await jax_run_presence_load(je, n_players=500, n_games=5,
                                    n_ticks=3, seed=2)
        jl = je.ledger
        names = [name for name, _slot in sorted(jl.slots.items(),
                                                key=lambda kv: kv[1])]
        ledger_state_from_numpy(
            pe.ledger, names, jl._host_hist,
            None if jl._hist is None else np.asarray(jl._hist))
        return je, pe

    je, pe = run(main())
    _assert_ledger_matches(je, pe)
    pe.ledger.record_host("PresenceGrain", "heartbeat", 3, 7)
    je.ledger.record_host("PresenceGrain", "heartbeat", 3, 7)
    _assert_ledger_matches(je, pe)
