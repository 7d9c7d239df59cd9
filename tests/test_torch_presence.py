"""Differential tests of the port's Presence tick against the JAX package.

The same seeded load goes through ``orleans_tpu`` (JAX on the CPU, with
auto-fusion, the latency ledger and attribution off) and through
``orleans_tpu_torch`` on ``device="cpu"`` with attribution off too
(tests/test_torch_attribution.py holds the plane against JAX's), where
every kernel wrapper takes its plain PyTorch version.  Arenas are
compared column by column BY KEY: integer columns exactly, the float fan-in column within twice Higham's summation bound,
``2 * (k - 1) * 2**-24 * sum|x|`` for the ``k`` scores summed into a game
(``k`` is the game's ``updates`` count; all scores are positive, so
``sum|x|`` is the total itself).  Also here: mirrors of the JAX engine
tests in tests/test_tensor_engine.py, run against the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from orleans_tpu.config import MetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.core.grain import batched_method as jax_batched_method
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import VectorGrain as JaxVectorGrain
from orleans_tpu.tensor import field as jax_field
from orleans_tpu.tensor import seg_sum as jax_seg_sum
from orleans_tpu.tensor import vector_grain as jax_vector_grain
from orleans_tpu.tensor.vector_grain import scatter_rows as jax_scatter_rows
from samples.presence import run_presence_load as jax_run_presence_load

from orleans_tpu_torch.config import MetricsConfig as PortMetricsConfig
from orleans_tpu_torch.convert import arena_state_from_numpy
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.samples.presence import (
    presence_inputs,
    run_presence_load,
)
from orleans_tpu_torch.tensor import (
    Batch,
    TensorEngine,
    VectorGrain,
    field,
    seg_sum,
    vector_grain,
)
from orleans_tpu_torch.tensor.vector_grain import scatter_rows, vector_type


@vector_grain
class AccumGrain(VectorGrain):
    """The port twin of tests/test_tensor_engine.py's AccumGrain."""

    total = field(torch.float32, 0.0)
    count = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def add(state, batch: Batch, n_rows: int):
        state = {
            **state,
            "total": state["total"] + seg_sum(batch.args["v"], batch.rows,
                                              n_rows),
            "count": state["count"] + seg_sum(
                torch.ones_like(batch.rows, dtype=torch.int32) * batch.mask,
                batch.rows, n_rows),
        }
        results = {"echo": batch.args["v"] * 2}
        return state, results, ()


@jax_vector_grain
class TwinLedgerGrain(JaxVectorGrain):
    """A host-path grain declared identically in both packages: a float
    fan-in, an int fan-in, a last-writer column and per-lane results."""

    total = jax_field(jnp.float32, 0.0)
    count = jax_field(jnp.int32, 0)
    last = jax_field(jnp.int32, -1)

    @jax_batched_method
    @staticmethod
    def post(state, batch, n_rows):
        args = batch.args
        state = {
            **state,
            "total": state["total"] + jax_seg_sum(args["v"], batch.rows,
                                                  n_rows),
            "count": state["count"] + jax_seg_sum(
                batch.mask.astype(jnp.int32), batch.rows, n_rows),
            "last": jax_scatter_rows(state["last"], batch.rows,
                                     jnp.broadcast_to(args["tag"],
                                                      batch.rows.shape)),
        }
        return state, {"twice": args["v"] * 2}, ()


JaxTwinLedgerGrain = TwinLedgerGrain


@vector_grain
class TwinLedgerGrain(VectorGrain):  # noqa: F811 — the port twin
    total = field(torch.float32, 0.0)
    count = field(torch.int32, 0)
    last = field(torch.int32, -1)

    @batched_method
    @staticmethod
    def post(state, batch, n_rows):
        args = batch.args
        state = {
            **state,
            "total": state["total"] + seg_sum(args["v"], batch.rows, n_rows),
            "count": state["count"] + seg_sum(batch.mask.to(torch.int32),
                                              batch.rows, n_rows),
            "last": scatter_rows(state["last"], batch.rows, args["tag"]),
        }
        return state, {"twice": args["v"] * 2}, ()


def _jax_engine(**kw):
    return JaxTensorEngine(
        config=JaxEngineConfig(auto_fusion_ticks=0),
        metrics=MetricsConfig(ledger_enabled=False,
                              attribution_enabled=False), **kw)


def _port_engine(**kw):
    """The port engine a differential test holds against ``_jax_engine``:
    attribution off on both sides."""
    return TensorEngine(device="cpu", metrics=PortMetricsConfig(
        attribution_enabled=False), **kw)


def _assert_arena_matches(jax_engine, port_engine, type_name):
    ja = jax_engine.arena_for(type_name)
    pa = port_engine.arena_for(type_name)
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(keys, np.sort(pa.keys()))
    jrows, jfound = ja.lookup_rows(keys)
    prows, pfound = pa.lookup_rows(keys)
    assert jfound.all() and pfound.all()
    for name, col in ja.state.items():
        want = np.asarray(col)[jrows]
        got = pa.state[name].cpu().numpy()[prows]
        assert got.dtype == want.dtype, name
        if want.dtype.kind == "f":
            k = np.asarray(ja.state["updates"])[jrows]
            tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * np.abs(want)
            assert np.all(np.abs(got - want) <= tol), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_presence_matches(jax_engine, port_engine):
    for type_name in ("PresenceGrain", "GameGrain"):
        _assert_arena_matches(jax_engine, port_engine, type_name)


# -- the step itself ----------------------------------------------------------

def test_entry_twin_matches_jax_entry():
    """The heartbeat handler at __graft_entry__.entry()'s shape (1024
    rows, 256 lanes) returns the same new state and emit."""
    fn, (state, rows, args, mask) = __graft_entry__.entry()
    want_state, want_emits = fn(state, rows, args, mask)

    info = vector_type("PresenceGrain")
    n_rows, m = 1024, 256
    port_state = {name: torch.full((n_rows, *f.shape), f.init,
                                   dtype=f.dtype)
                  for name, f in info.state_fields.items()}
    batch = Batch(rows=torch.arange(m, dtype=torch.int32),
                  args={"game": torch.zeros(m, dtype=torch.int32),
                        "score": torch.ones(m, dtype=torch.float32),
                        "tick": np.int32(1)},
                  mask=torch.ones(m, dtype=torch.bool))
    got_state, results, got_emits = info.handlers["heartbeat"](
        port_state, batch, n_rows)
    assert results is None
    assert set(got_state) == set(want_state)
    for name in want_state:
        np.testing.assert_array_equal(got_state[name].numpy(),
                                      np.asarray(want_state[name]))
    (want,), (got,) = want_emits, got_emits
    assert (got.interface, got.method) == (want.interface, want.method)
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert set(got.args) == set(want.args)
    for name in want.args:
        np.testing.assert_array_equal(got.args[name].numpy(),
                                      np.asarray(want.args[name]))


# -- the slice end to end -----------------------------------------------------

@pytest.mark.parametrize(
    "device_payloads,measure_latency,rounds",
    [(True, False, 4), (False, True, 4), (True, False, 1)])
def test_presence_load_matches_jax(run, device_payloads, measure_latency,
                                   rounds):
    """2,000 players, 20 games, 3 ticks through both engines: the cold
    tick resolves the game emits by binary search against an empty arena,
    misses every lane, activates the games at the drain and redelivers;
    later lanes resolve through the dense map.  ``rounds=1`` caps each
    tick at one round, so every game emit spills into the next tick."""
    kw = dict(n_players=2000, n_games=20, n_ticks=3, seed=3,
              device_payloads=device_payloads,
              measure_latency=measure_latency)

    async def main():
        je = _jax_engine()
        je.config.max_rounds_per_tick = rounds
        jstats = await jax_run_presence_load(je, **kw)
        pe = _port_engine()
        pe.config.max_rounds_per_tick = rounds
        pstats = await run_presence_load(pe, **kw)
        return je, jstats, pe, pstats

    je, jstats, pe, pstats = run(main())
    # the port's sample also returns the ledger's and the attribution
    # plane's snapshots
    assert set(pstats) == set(jstats) | {"ledger", "attribution"}
    assert pstats["attribution"]["arenas"] == {}  # the plane is off
    assert pstats["autofuse"] == jstats["autofuse"]  # never engaged
    for key in ("players", "games", "ticks", "messages"):
        assert pstats[key] == jstats[key]
    assert pe.messages_processed == je.messages_processed
    assert pe.activation_passes == je.activation_passes
    assert pe.rounds_run == je.rounds_run
    _assert_presence_matches(je, pe)


def test_host_key_batches_match_jax(run):
    """Host-key batches through both engines: consecutive batches merge,
    pad to a bucket, carry a scalar arg and return per-lane results."""
    rng = np.random.default_rng(9)
    # keys repeat within a batch (fan-in); each batch owns its key range,
    # so every writer of a key's ``last`` carries the same tag (SET keeps
    # one writer of duplicates, not a chosen one)
    sends = [(rng.integers(100 * tag, 100 * tag + 100, n).astype(np.int64),
              rng.standard_normal(n).astype(np.float32), tag)
             for tag, n in enumerate((5, 300, 41))]

    async def drive(engine):
        futures = [engine.send_batch("TwinLedgerGrain", "post", keys,
                                     {"v": v, "tag": np.int32(tag)},
                                     want_results=(tag == 2))
                   for keys, v, tag in sends]
        await engine.flush()
        return futures[2].result()

    async def main():
        je, pe = _jax_engine(), _port_engine()
        return je, await drive(je), pe, await drive(pe)

    je, jres, pe, pres = run(main())
    np.testing.assert_array_equal(pres["twice"], np.asarray(jres["twice"]))
    assert pe.messages_processed == je.messages_processed
    ja, pa = je.arena_for("TwinLedgerGrain"), pe.arena_for("TwinLedgerGrain")
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(keys, np.sort(pa.keys()))
    jrows, prows = ja.lookup_rows(keys)[0], pa.lookup_rows(keys)[0]
    count = np.asarray(ja.state["count"])[jrows]
    np.testing.assert_array_equal(pa.state["count"].numpy()[prows], count)
    np.testing.assert_array_equal(pa.state["last"].numpy()[prows],
                                  np.asarray(ja.state["last"])[jrows])
    want = np.asarray(ja.state["total"])[jrows]
    mag = np.zeros(len(keys))
    for k, v, _ in sends:
        np.add.at(mag, np.searchsorted(keys, k), np.abs(v))
    tol = 2 * np.maximum(count - 1, 0) * 2.0**-24 * mag
    assert np.all(np.abs(pa.state["total"].numpy()[prows] - want) <= tol)


def test_state_carried_across_matches_next_tick(run):
    """Run JAX for 2 ticks, load its arenas into the port with
    convert.arena_state_from_numpy, run one more tick in both."""
    n_players, n_games = 1500, 15

    async def main():
        je = _jax_engine()
        await jax_run_presence_load(je, n_players=n_players,
                                    n_games=n_games, n_ticks=2, seed=5)
        pe = _port_engine()
        for name in ("PresenceGrain", "GameGrain"):
            ja = je.arena_for(name)
            arena_state_from_numpy(
                pe.arena_for(name), ja._key_of_row,
                {k: np.asarray(v) for k, v in ja.state.items()})
        _assert_presence_matches(je, pe)

        players, games, scores = presence_inputs(n_players, n_games, seed=5)
        args = {"game": games, "score": scores, "tick": np.int32(3)}
        before = je.messages_processed
        je.make_injector("PresenceGrain", "heartbeat", players).inject(args)
        await je.flush()
        pe.make_injector("PresenceGrain", "heartbeat", players).inject(
            dict(args))
        await pe.flush()
        return je, pe, je.messages_processed - before

    je, pe, jax_messages = run(main())
    assert pe.messages_processed == jax_messages == 2 * n_players
    _assert_presence_matches(je, pe)
    # the games were live when the tick ran: no miss, no activation
    assert pe.activation_passes == 0
    assert int(pe.arena_for("PresenceGrain").read_row(7)["heartbeats"]) == 3


# -- mirrors of tests/test_tensor_engine.py -----------------------------------

def test_arena_resolve_and_autoactivate():
    engine = TensorEngine(device="cpu")
    arena = engine.arena_for("AccumGrain")
    keys = np.array([5, 7, 5, 9], dtype=np.int64)
    rows = arena.resolve_rows(keys)
    assert rows[0] == rows[2] and rows[0] != rows[1]
    assert arena.live_count == 3
    np.testing.assert_array_equal(rows, arena.resolve_rows(keys))


def test_arena_growth_preserves_state(run):
    async def main():
        engine = TensorEngine(initial_capacity=8, device="cpu")
        engine.send_batch("AccumGrain", "add", np.array([1]),
                          {"v": np.array([10.0], np.float32)})
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        generation = arena.generation
        arena.resolve_rows(np.arange(100, 200, dtype=np.int64))
        assert arena.generation > generation and arena.capacity >= 101
        row = arena.read_row(1)
        assert row is not None and float(row["total"]) == 10.0

    run(main())


def test_batched_fan_in_matches_sequential(run):
    async def main():
        engine = TensorEngine(device="cpu")
        keys = np.array([1, 2, 1, 1, 2], dtype=np.int64)
        vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], dtype=np.float32)
        fut = engine.send_batch("AccumGrain", "add", keys, {"v": vals},
                                want_results=True)
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        assert float(arena.read_row(1)["total"]) == 8.0   # 1+3+4
        assert float(arena.read_row(2)["total"]) == 7.0   # 2+5
        assert int(arena.read_row(1)["count"]) == 3
        np.testing.assert_allclose(fut.result()["echo"], vals * 2)

    run(main())


def test_bucket_padding_does_not_corrupt(run):
    async def main():
        engine = TensorEngine(device="cpu")
        # 3 messages → padded to bucket 256; pads must not touch row 0
        engine.send_batch("AccumGrain", "add", np.array([3, 4, 5]),
                          {"v": np.ones(3, np.float32)})
        await engine.flush()
        arena = engine.arena_for("AccumGrain")
        for k in (3, 4, 5):
            assert float(arena.read_row(k)["total"]) == 1.0
            assert int(arena.read_row(k)["count"]) == 1

    run(main())


def test_presence_emit_chain(run):
    async def main():
        engine = TensorEngine(device="cpu")
        n_players, n_games = 1000, 10
        stats = await run_presence_load(engine, n_players=n_players,
                                        n_games=n_games, n_ticks=3)
        assert stats["messages"] == 2 * n_players * 3
        game_arena = engine.arena_for("GameGrain")
        assert game_arena.live_count == n_games
        assert sum(int(game_arena.read_row(g)["updates"])
                   for g in range(n_games)) == n_players * 3
        presence = engine.arena_for("PresenceGrain")
        assert presence.live_count == n_players
        assert int(presence.read_row(0)["heartbeats"]) == 3

    run(main())


def test_multi_round_tick_caps_and_spills(run):
    """Emit chains longer than max_rounds_per_tick spill to the next tick."""

    async def main():
        engine = TensorEngine(device="cpu")
        engine.config.max_rounds_per_tick = 2
        n = 100
        stats = await run_presence_load(engine, n_players=n, n_games=2,
                                        n_ticks=1)
        assert engine.rounds_run >= 2
        assert stats["messages"] == 2 * n

    run(main())


def test_undonated_step_leaves_live_columns_intact(run):
    """donate_state=False: the step clones the columns first, so a
    column tensor the caller held before the tick keeps its values."""

    async def main():
        engine = TensorEngine(device="cpu")
        engine.config.donate_state = False
        arena = engine.arena_for("AccumGrain")
        arena.resolve_rows(np.array([1], dtype=np.int64))
        held = arena.state["count"]
        engine.send_batch("AccumGrain", "add", np.array([1]),
                          {"v": np.ones(1, np.float32)})
        await engine.flush()
        assert int(held.sum()) == 0
        assert int(arena.read_row(1)["count"]) == 1

    run(main())


def test_parked_miss_check_redelivers_emit_time_payload(run):
    """A cold tick's game emits miss and park a miss-check; the loader then
    rewrites its ``game`` and ``score`` tensors in place (the PyTorch way
    to refresh a payload) after the tick and before the drain.  The drain
    must activate and redeliver what the tick emitted, as the JAX package
    does (its arrays cannot change): the parked check holds copies."""
    n_players, n_games = 200, 10
    players, games, scores = presence_inputs(n_players, n_games, seed=6)
    new_games = ((games + 3) % (2 * n_games)).astype(np.int32)
    new_scores = (scores * 2 + 1).astype(np.float32)

    async def drive(engine, game, score, rewrite):
        engine.arena_for("GameGrain").reserve(2 * n_games)
        inj = engine.make_injector("PresenceGrain", "heartbeat", players)
        inj.inject({"game": game, "score": score, "tick": np.int32(1)})
        await engine.drain_queues()   # every game emit misses: parked
        assert engine.activation_passes == 0
        rewrite(game, score)
        await engine.flush()          # the drain activates and redelivers
        return engine

    def in_place(game, score):
        game.copy_(torch.from_numpy(new_games))
        score.copy_(torch.from_numpy(new_scores))

    async def main():
        # JAX: the loader's next arrays are new arrays; the emitted ones
        # stand as they were
        je = await drive(_jax_engine(), jnp.asarray(games),
                         jnp.asarray(scores), lambda g, s: None)
        pe = await drive(_port_engine(), torch.from_numpy(games.copy()),
                         torch.from_numpy(scores.copy()), in_place)
        return je, pe

    je, pe = run(main())
    assert pe.activation_passes == je.activation_passes == 1
    assert pe.messages_processed == je.messages_processed
    _assert_presence_matches(je, pe)
    ga = pe.arena_for("GameGrain")
    assert sorted(ga.keys().tolist()) == sorted(set(games.tolist()))
    rows, _ = ga.lookup_rows(np.arange(n_games, dtype=np.int64))
    np.testing.assert_array_equal(ga.state["updates"].numpy()[rows],
                                  np.bincount(games, minlength=n_games))


@pytest.mark.parametrize("keys_kind", ["device", "host"])
def test_send_batch_delivers_enqueue_time_values(run, keys_kind):
    """A caller rewrites its key and payload tensors in place after
    ``send_batch`` and before the tick runs: the engine delivers what was
    sent (its batch holds copies), as the JAX package does with its
    immutable arrays.  ``device``: int32 keys (the optimistic device
    path); ``host``: int64 keys (the host path)."""
    n_games = 12
    rng = np.random.default_rng(8)
    keys = rng.integers(0, n_games, 300).astype(np.int32)
    scores = rng.random(300, dtype=np.float32)
    counts = np.ones(300, np.int32)
    dtype = torch.int32 if keys_kind == "device" else torch.int64

    async def drive(engine, k, s, c, rewrite):
        engine.arena_for("GameGrain").reserve(2 * n_games)
        engine.send_batch("GameGrain", "update_game_status", k,
                          {"score": s, "count": c})
        rewrite(k, s, c)
        await engine.flush()
        return engine

    def in_place(k, s, c):
        k.copy_((k + 5) % (2 * n_games))
        s.mul_(3)
        c.fill_(7)

    async def main():
        # JAX takes int32 device arrays, or int64 host arrays (a JAX array
        # without x64 would be int32)
        jkeys = jnp.asarray(keys) if keys_kind == "device" \
            else keys.astype(np.int64)
        je = await drive(_jax_engine(), jkeys, jnp.asarray(scores),
                         jnp.asarray(counts), lambda *a: None)
        pe = await drive(_port_engine(),
                         torch.from_numpy(keys.copy()).to(dtype),
                         torch.from_numpy(scores.copy()),
                         torch.from_numpy(counts.copy()), in_place)
        return je, pe

    je, pe = run(main())
    assert pe.activation_passes == je.activation_passes
    _assert_arena_matches(je, pe, "GameGrain")
    ga = pe.arena_for("GameGrain")
    rows, _ = ga.lookup_rows(np.arange(n_games, dtype=np.int64))
    np.testing.assert_array_equal(ga.state["updates"].numpy()[rows],
                                  np.bincount(keys, minlength=n_games))


def test_round_cap_spill_delivers_emit_time_values(run):
    """With one round per tick, the heartbeat's game emits spill to the
    next tick; they forward the loader's own ``game`` and ``score``
    tensors, which the loader rewrites in place between the two ticks.
    The spilled batch holds copies: the next tick delivers what was
    emitted, as the JAX package does."""
    n_players, n_games = 200, 10
    players, games, scores = presence_inputs(n_players, n_games, seed=9)

    async def drive(engine, game, score, rewrite):
        engine.config.max_rounds_per_tick = 1
        engine.arena_for("GameGrain").resolve_rows(
            np.arange(2 * n_games, dtype=np.int64))
        inj = engine.make_injector("PresenceGrain", "heartbeat", players)
        inj.inject({"game": game, "score": score, "tick": np.int32(1)})
        engine.run_tick()             # heartbeats apply, game emits spill
        assert any(engine.queues.values())
        rewrite(game, score)
        await engine.flush()
        return engine

    def in_place(game, score):
        game.add_(n_games)
        score.fill_(9.0)

    async def main():
        je = await drive(_jax_engine(), jnp.asarray(games),
                         jnp.asarray(scores), lambda g, s: None)
        pe = await drive(_port_engine(), torch.from_numpy(games.copy()),
                         torch.from_numpy(scores.copy()), in_place)
        return je, pe

    je, pe = run(main())
    assert pe.messages_processed == je.messages_processed
    _assert_arena_matches(je, pe, "GameGrain")
    ga = pe.arena_for("GameGrain")
    rows, _ = ga.lookup_rows(np.arange(2 * n_games, dtype=np.int64))
    np.testing.assert_array_equal(
        ga.state["updates"].numpy()[rows],
        np.bincount(games, minlength=2 * n_games))
