"""Differential tests of the port's wide-key path against the JAX package.

Grain keys in ``[0, 2**63)`` ride as ``(hi, lo)`` int32 word pairs and
resolve on the device through the arena's two-level wide mirror: a 30-bit
hash of the words, a lower-bound search of the sorted hashes and up to
four candidates checked against the full words (K10 ``resolve_wide``,
here its plain version).  The same seeded inputs, made with numpy, go
through ``orleans_tpu`` (JAX on the CPU) and ``orleans_tpu_torch`` on
``device="cpu"``.  Hashes, mirrors, rows and miss counts must be equal;
arenas are compared by key, integer columns exactly and the float fan-in
within twice Higham's bound for recursive summation, ``2 * (k - 1) *
2**-24 * sum|x|`` over the ``k`` summed terms (``k`` is the game's
``updates``; every score is positive, so ``sum|x|`` is the total).  The
engine twins mirror tests/test_wide_keys.py and
tests/test_tensor_engine.py::test_wide_keys_resolve_on_device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.core.grain import batched_method as jax_batched_method
from orleans_tpu.tensor import Batch as JaxBatch
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import VectorGrain as JaxVectorGrain
from orleans_tpu.tensor import field as jax_field
from orleans_tpu.tensor import seg_sum as jax_seg_sum
from orleans_tpu.tensor import vector_grain as jax_vector_grain
from orleans_tpu.tensor import arena as jax_arena
from orleans_tpu.tensor import engine as jax_engine_mod
from samples import presence_wide as jax_presence_wide

from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels.resolve import (
    KEY_SENTINEL,
    mix32,
    resolve_wide,
    resolve_wide_plain,
)
from orleans_tpu_torch.samples import presence_wide
from orleans_tpu_torch.tensor import (
    Batch,
    TensorEngine,
    VectorGrain,
    field,
    seg_sum,
    vector_grain,
)
from orleans_tpu_torch.tensor.arena import (
    join_wide_keys,
    mix32_np,
    split_wide_keys,
)
from orleans_tpu_torch.tensor.engine import resolve_rows_on_device


@pytest.fixture
def jax_trace_shim(monkeypatch):
    """The installed JAX lacks ``jax.core.trace_state_clean``, which the
    JAX attribution plane's flush calls (see tests/
    test_torch_attribution.py)."""
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@jax_vector_grain
class WideAccumGrain(JaxVectorGrain):
    """tests/test_tensor_engine.py's AccumGrain, under a name of its own."""

    total = jax_field(jnp.float32, 0.0)
    count = jax_field(jnp.int32, 0)

    @jax_batched_method
    @staticmethod
    def add(state, batch: JaxBatch, n_rows: int):
        ones = jnp.ones_like(batch.rows, dtype=jnp.int32) * batch.mask
        state = {**state,
                 "total": state["total"] + jax_seg_sum(batch.args["v"],
                                                       batch.rows, n_rows),
                 "count": state["count"] + jax_seg_sum(ones, batch.rows,
                                                       n_rows)}
        return state, {"echo": batch.args["v"] * 2}, ()


@vector_grain
class WideAccumGrain(VectorGrain):  # noqa: F811 — the port twin
    total = field(torch.float32, 0.0)
    count = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def add(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows) * batch.mask
        state = {**state,
                 "total": state["total"] + seg_sum(batch.args["v"],
                                                   batch.rows, n_rows),
                 "count": state["count"] + seg_sum(ones, batch.rows,
                                                   n_rows)}
        return state, {"echo": batch.args["v"] * 2}, ()


# -- inputs -------------------------------------------------------------------

def _colliding_keys(rng, n_draws: int = 300_000) -> np.ndarray:
    """Wide keys in pairs (or runs) of equal 30-bit hashes: random keys
    hashed with ``mix32_np``, keeping every key whose hash repeats."""
    keys = np.unique(rng.integers(2**31, 2**63 - 1, n_draws,
                                  dtype=np.int64))
    h = mix32_np(*split_wide_keys(keys))
    _, inverse, counts = np.unique(h, return_inverse=True,
                                   return_counts=True)
    out = keys[counts[inverse] > 1]
    assert len(out) >= 4, "too few hash collisions drawn"
    return out


def _edge_keys() -> np.ndarray:
    """Keys whose words are INT32_MIN, INT32_MAX, -1 and 0, negative words
    included (a word is a bit pattern)."""
    words = np.array([0, 1, -1, 2**31 - 1, -2**31, -2], np.int64) & 0xFFFFFFFF
    his = words[words < 2**31]  # a key's top bit is 0
    keys = (his[:, None] << 32) | words[None, :]
    return np.unique(keys.ravel())


def _both_arenas(keys: np.ndarray):
    """A JAX and a port WideAccumGrain arena holding ``keys``."""
    je = JaxTensorEngine(metrics=JaxMetricsConfig(attribution_enabled=False))
    pe = TensorEngine(device="cpu",
                      metrics=MetricsConfig(attribution_enabled=False))
    ja, pa = je.arena_for("WideAccumGrain"), pe.arena_for("WideAccumGrain")
    ja.resolve_rows(keys)
    pa.resolve_rows(keys)
    return ja, pa


# -- the hash and the kernel --------------------------------------------------

def test_word_split_roundtrip():
    keys = np.array([0, 1, 2**31 - 1, 2**31, 2**40 + 7, 2**62 + 3,
                     2**63 - 1], dtype=np.int64)
    hi, lo = split_wide_keys(keys)
    np.testing.assert_array_equal(join_wide_keys(hi, lo), keys)
    jhi, jlo = jax_arena.split_wide_keys(keys)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)


def test_mix32_matches_jax():
    rng = np.random.default_rng(0)
    keys = np.concatenate([_colliding_keys(rng), _edge_keys(),
                           rng.integers(0, 2**63 - 1, 5000,
                                        dtype=np.int64)])
    hi, lo = split_wide_keys(keys)
    want = jax_arena.mix32_np(hi, lo)
    np.testing.assert_array_equal(
        np.asarray(jax_engine_mod._mix32_dev(jnp.asarray(hi),
                                             jnp.asarray(lo))), want)
    np.testing.assert_array_equal(mix32_np(hi, lo), want)
    np.testing.assert_array_equal(
        mix32(torch.from_numpy(hi), torch.from_numpy(lo)).numpy(), want)


@pytest.mark.parametrize("mode", ["wide", "narrow_into_wide"])
def test_resolve_wide_matches_jax(mode):
    """Live keys with colliding hashes, edge words, small keys and the key
    2**31 - 1 itself; lanes of live keys, unseen keys (some sharing a live
    key's hash), padding and masked lanes.  The mirrors of both arenas
    and the resolved rows and miss counts must be equal."""
    rng = np.random.default_rng(1)
    colliding = _colliding_keys(rng)
    live = np.unique(np.concatenate([
        colliding[::2], _edge_keys(), np.array([5, 77, 2**31 - 1]),
        rng.integers(2**31, 2**63 - 1, 300, dtype=np.int64)]))
    ja, pa = _both_arenas(live)
    for got, want in zip(pa.device_index_wide(), ja.device_index_wide()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    m = 4096
    if mode == "wide":
        pool = np.concatenate([live, colliding[1::2],
                               rng.integers(0, 2**63 - 1, 64,
                                            dtype=np.int64)])
        hi, lo = split_wide_keys(rng.choice(pool, m))
        lanes = (hi, lo)
    else:
        pool = np.array([5, 77, 2**31 - 1, 6, 0, -7], np.int64)
        lo = rng.choice(pool, m).astype(np.int32)
        lanes = lo
    valid = rng.random(m) < 0.85
    jkeys = tuple(jnp.asarray(k) for k in lanes) \
        if isinstance(lanes, tuple) else jnp.asarray(lanes)
    pkeys = tuple(torch.from_numpy(k) for k in lanes) \
        if isinstance(lanes, tuple) else torch.from_numpy(lanes)
    want_rows, want_miss = jax_engine_mod.resolve_rows_on_device(
        ja, jkeys, jnp.asarray(valid))
    got_rows, got_miss = resolve_rows_on_device(pa, pkeys,
                                                torch.from_numpy(valid))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert int(got_miss) == int(want_miss)
    assert (got_rows.numpy() >= 0).any() and int(got_miss) > 0
    if mode == "narrow_into_wide":
        # the padding lane 2**31 - 1 never resolves to the live grain
        assert (got_rows.numpy()[lo == KEY_SENTINEL] == -1).all()


def test_resolve_wide_probe_depth_matches_jax():
    """A synthetic mirror with a run of six equal hashes: keys behind the
    fourth candidate miss on both sides, repeated probes at the end of the
    mirror agree, and the count adds into a given counter."""
    rng = np.random.default_rng(2)
    pair = _colliding_keys(rng)
    pair = pair[mix32_np(*split_wide_keys(pair))
                == mix32_np(*split_wide_keys(pair[:1]))][:2]
    keys = np.concatenate([pair, rng.integers(2**31, 2**63 - 1, 6,
                                              dtype=np.int64)])
    hi, lo = split_wide_keys(keys)
    h0 = int(mix32_np(hi[:1], lo[:1])[0])
    n, cap = 10, 16
    sorted_h = np.full(n, 2**31 - 1, np.int32)
    sorted_h[1:7] = h0                   # the run, then padding
    sorted_h[0] = max(h0 - 5, 0)
    sorted_h[7:9] = [h0 + 1, h0 + 2]
    rows_by_h = np.full(n, -1, np.int32)
    rows_by_h[1:7] = np.arange(1, 7)
    rows_by_h[0], rows_by_h[7] = 9, 8
    hi_col = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    lo_col = rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)
    # keys 0 and 1 share their hash: key 0 sits behind the fourth
    # candidate (row 6), key 1 at the second (row 2)
    hi_col[6], lo_col[6] = hi[0], lo[0]
    hi_col[2], lo_col[2] = hi[1], lo[1]
    q_hi = np.concatenate([hi, [hi[1], hi[1]]]).astype(np.int32)
    q_lo = np.concatenate([lo, [lo[1], lo[1]]]).astype(np.int32)
    valid = np.ones(len(q_hi), bool)
    valid[-1] = False
    mirror = (sorted_h, rows_by_h, hi_col, lo_col)
    want_rows, want_miss = jax_engine_mod._resolve_rows_wide_kernel(
        *(jnp.asarray(a) for a in mirror), jnp.asarray(q_hi),
        jnp.asarray(q_lo), jnp.asarray(valid))
    counter = torch.full((1,), 7, dtype=torch.int32)
    got_rows, got = resolve_wide(*(torch.from_numpy(a) for a in mirror),
                                 torch.from_numpy(q_hi),
                                 torch.from_numpy(q_lo),
                                 torch.from_numpy(valid), counter)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert got is counter and int(counter[0]) == 7 + int(want_miss)
    plain_rows, _ = resolve_wide_plain(*(torch.from_numpy(a)
                                         for a in mirror),
                                       torch.from_numpy(q_hi),
                                       torch.from_numpy(q_lo),
                                       torch.from_numpy(valid))
    assert torch.equal(plain_rows, got_rows)
    assert got_rows[0] == -1 and got_rows[1] == got_rows[len(keys)] == 2
    assert got_rows[-1] == -1  # masked


# -- engine twins -------------------------------------------------------------

def _engines(**cfg):
    """A JAX and a port engine with attribution off on both."""
    cfg.setdefault("auto_fusion_ticks", 0)
    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg),
                         metrics=JaxMetricsConfig(attribution_enabled=False))
    pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg),
                      metrics=MetricsConfig(attribution_enabled=False))
    return je, pe


def _assert_arena_matches(je, pe, type_name, float_count=None):
    ja, pa = je.arena_for(type_name), pe.arena_for(type_name)
    keys = np.sort(ja.keys())
    np.testing.assert_array_equal(keys, np.sort(pa.keys()))
    jrows, jfound = ja.lookup_rows(keys)
    prows, pfound = pa.lookup_rows(keys)
    assert jfound.all() and pfound.all()
    assert pa.has_wide_keys == ja.has_wide_keys
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


def _assert_wide_presence_matches(je, pe):
    _assert_arena_matches(je, pe, "WidePresence")
    _assert_arena_matches(je, pe, "WideGame", float_count="updates")
    assert pe.messages_processed == je.messages_processed
    assert pe.activation_passes == je.activation_passes
    assert pe.autofuser.snapshot() == je.autofuser.snapshot()


def _wide_load(n_players, n_games, seed=0):
    players, games, _index, words, scores = \
        presence_wide.wide_presence_inputs(n_players, n_games, seed)
    return players, games, words[0], words[1], scores


def test_wide_emits_deliver_on_device_path(run):
    """Emits to pre-activated wide game keys resolve on the device: no
    activation pass after the warm half, counts exact, equal to JAX."""
    n_players, n_games, T = 3000, 40, 6
    players = np.arange(n_players, dtype=np.int64)
    games = presence_wide.wide_game_keys(n_games)
    hi, lo = split_wide_keys(games[players % n_games])

    async def drive(eng, asarray):
        eng.arena_for("WidePresence").reserve(n_players)
        garena = eng.arena_for("WideGame")
        garena.reserve(n_games)
        garena.resolve_rows(games)
        inj = eng.make_injector("WidePresence", "heartbeat", players)
        args = {"game_hi": asarray(hi), "game_lo": asarray(lo),
                "score": asarray(np.ones(n_players, np.float32))}
        passes = []
        for _half in range(2):
            for _t in range(T):
                inj.inject(args)
                await eng.drain_queues()
            passes.append(eng.activation_passes)
        await eng.flush()
        return passes

    je, pe = _engines()
    run(drive(je, jnp.asarray))
    passes = run(drive(pe, torch.from_numpy))
    assert passes[1] == passes[0] == 0
    garena = pe.arena_for("WideGame")
    assert garena._dev_wide is not None and garena.has_wide_keys
    rows, found = garena.lookup_rows(games)
    assert found.all()
    updates = garena.state["updates"].numpy()[rows]
    np.testing.assert_array_equal(updates, 2 * T * (n_players // n_games))
    _assert_wide_presence_matches(je, pe)


def test_wide_cold_destination_redelivers_exactly(run):
    """Wide emits to UNSEEN keys miss on the device and go again through
    the exact host path: activated, delivered once, equal to JAX."""
    n = 64
    players = np.arange(n, dtype=np.int64)
    cold = presence_wide.wide_game_keys(3)
    hi, lo = split_wide_keys(cold[players % 3])

    async def drive(eng, asarray):
        eng.arena_for("WideGame")
        inj = eng.make_injector("WidePresence", "heartbeat", players)
        inj.inject({"game_hi": asarray(hi), "game_lo": asarray(lo),
                    "score": asarray(np.ones(n, np.float32))})
        await eng.flush()

    je, pe = _engines()
    run(drive(je, jnp.asarray))
    run(drive(pe, torch.from_numpy))
    garena = pe.arenas["WideGame"]
    rows, found = garena.lookup_rows(cold)
    assert found.all(), "cold wide keys did not activate"
    assert int(garena.state["updates"].numpy()[rows].sum()) == n
    assert pe.activation_passes == 1
    _assert_wide_presence_matches(je, pe)


def test_wide_presence_fuses(run):
    """Wide emits inside a fused window resolve through the wide mirror
    (K10 adding into the window's miss total); equal to JAX."""
    n_players, n_games, T = 1000, 20, 4
    players = np.arange(n_players, dtype=np.int64)
    games = presence_wide.wide_game_keys(n_games)
    hi, lo = split_wide_keys(games[players % n_games])

    def drive(eng, asarray):
        eng.arena_for("WidePresence").reserve(n_players)
        eng.arena_for("WideGame").resolve_rows(games)
        prog = eng.fuse_ticks("WidePresence", "heartbeat", players)
        prog.run({"tick": asarray(np.arange(T, dtype=np.int32))},
                 static_args={"game_hi": asarray(hi),
                              "game_lo": asarray(lo),
                              "score": asarray(np.ones(n_players,
                                                       np.float32))})
        assert prog.verify() == 0
        return prog

    je, pe = _engines()
    drive(je, jnp.asarray)
    prog = drive(pe, torch.from_numpy)
    garena = pe.arenas["WideGame"]
    rows, _ = garena.lookup_rows(games)
    assert int(garena.state["updates"].numpy()[rows].sum()) \
        == T * n_players
    assert list(prog._mirrors) == [("WideGame", True)]
    _assert_wide_presence_matches(je, pe)
    # a new wide game rebuilds the mirror, and the window with it
    garena.resolve_rows(presence_wide.wide_game_keys(n_games + 1)[-1:])
    prog.run({"tick": torch.arange(T, dtype=torch.int32)},
             static_args={"game_hi": torch.from_numpy(hi),
                          "game_lo": torch.from_numpy(lo),
                          "score": torch.ones(n_players)})
    assert prog.verify() == 0 and prog.rebuilds["mirror_rebuild"] == 1


def test_wide_keys_resolve_on_device(run):
    """Keys beyond int32: host-path dispatch with results; then the wide
    mirror resolves the same keys to the same rows on the device, and the
    narrow mirror refuses them (twin of tests/test_tensor_engine.py)."""
    wide = np.array([2**40 + 1, 2**40 + 2], dtype=np.int64)

    async def main():
        engine = TensorEngine(device="cpu")
        arena = engine.arena_for("WideAccumGrain")
        fut = engine.send_batch("WideAccumGrain", "add", wide,
                                {"v": np.float32([1.0, 2.0])},
                                want_results=True)
        await engine.flush()
        res = await fut
        np.testing.assert_allclose(res["echo"], [2.0, 4.0])
        return engine, arena

    engine, arena = run(main())
    rows = arena.resolve_rows(wide)
    assert arena.live_count >= 2 and rows[0] != rows[1]
    assert arena.has_wide_keys
    hi, lo = split_wide_keys(wide)
    drows, miss = resolve_rows_on_device(
        arena, (torch.from_numpy(hi), torch.from_numpy(lo)),
        torch.ones(2, dtype=torch.bool))
    assert int(miss) == 0
    np.testing.assert_array_equal(drows.numpy(), rows)
    with pytest.raises(OverflowError, match="int32"):
        arena.device_index()


@pytest.mark.parametrize("load", ["steady", "moving_cold"])
def test_wide_presence_slice_matches_jax(jax_trace_shim, run, load):
    """Both engines at the defaults but a shorter auto-fusion (after 3
    identical ticks, 4-tick windows, verify every 2), the ledger and the
    attribution plane on, from a cold start (every wide game unseen: the
    first ticks' emits miss and go through the host path).  ``steady``:
    static game words on the device, then fused windows.  ``moving_cold``:
    the words a fresh host array every tick, one player moving to an
    unseen wide game at tick 22 — its window misses, rolls back and
    replays unfused.  Columns, counters, ledger and the plane must agree
    (the plane's float gauge within its tolerance)."""
    n_players, n_games, T = 256, 8, 30
    players, games, hi, lo, scores = _wide_load(n_players, n_games, seed=3)
    cold = presence_wide.wide_game_keys(n_games + 1)[-1]
    c_hi, c_lo = split_wide_keys(np.array([cold]))
    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4,
               auto_fusion_verify_windows=2)

    async def drive(eng, asarray):
        eng.arena_for("WidePresence").reserve(n_players)
        inj = eng.make_injector("WidePresence", "heartbeat", players)
        static = {"game_hi": asarray(hi), "game_lo": asarray(lo),
                  "score": asarray(scores)}
        for t in range(T):
            if load == "steady":
                args = dict(static)
            else:
                h, w = hi.copy(), lo.copy()
                if t >= 22:
                    h[0], w[0] = c_hi[0], c_lo[0]
                args = {"game_hi": h, "game_lo": w, "score": scores}
            inj.inject({**args, "tick": np.int32(t + 1)})
            await eng.drain_queues()
        await eng.flush()

    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg))
    pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))
    run(drive(je, jnp.asarray))
    run(drive(pe, torch.from_numpy))
    af = pe.autofuser.snapshot()
    assert af["windows_run"] >= 2
    assert af["windows_rolled_back"] == (load == "moving_cold")
    _assert_wide_presence_matches(je, pe)
    want, got = je.ledger.snapshot(), pe.ledger.snapshot()
    assert {k: (v["counts"], v["total"]) for k, v in got.items()} == \
        {k: (v["counts"], v["total"]) for k, v in want.items()}
    for t in ("WidePresence", "WideGame"):
        assert pe.attribution.per_key_totals(t) == \
            je.attribution.per_key_totals(t), t
    jsnap, psnap = je.attribution.snapshot(), pe.attribution.snapshot()
    for name, w in jsnap["arenas"].items():
        g = psnap["arenas"][name]
        assert g["hot"] == w["hot"] and g["total_msgs"] == w["total_msgs"]
    assert sum(pe.attribution.per_key_totals("WideGame").values()) == \
        got["WideGame.update"]["total"]


def test_jax_sample_registers_the_same_types():
    """The port's WidePresence/WideGame declare the JAX sample's fields,
    and its wide game keys are the JAX sample's."""
    from orleans_tpu.tensor.vector_grain import vector_type as jax_type
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    for name in ("WidePresence", "WideGame"):
        assert set(vector_type(name).state_fields) == \
            set(jax_type(name).state_fields)
    np.testing.assert_array_equal(presence_wide.wide_game_keys(50),
                                  jax_presence_wide.wide_game_keys(50))


def test_wide_arenas_carried_across_match_jax(run):
    """Arenas holding wide keys, carried from a JAX engine after a cold
    tick, then one more tick on both: the port resolves the wide emits
    through its wide mirror and both compute the same columns."""
    from orleans_tpu_torch.convert import arena_state_from_numpy

    n_players, n_games = 300, 12
    players, games, hi, lo, scores = _wide_load(n_players, n_games, seed=5)

    async def tick(eng, asarray):
        inj = eng.make_injector("WidePresence", "heartbeat", players)
        inj.inject({"game_hi": asarray(hi), "game_lo": asarray(lo),
                    "score": asarray(scores)})
        await eng.flush()

    je, pe = _engines()
    run(tick(je, jnp.asarray))
    for name in ("WidePresence", "WideGame"):
        ja = je.arena_for(name)
        arena_state_from_numpy(pe.arena_for(name), ja._key_of_row,
                               {k: np.asarray(v)
                                for k, v in ja.state.items()})
    assert pe.arena_for("WideGame").has_wide_keys
    passes = je.activation_passes
    run(tick(je, jnp.asarray))
    run(tick(pe, torch.from_numpy))
    assert je.activation_passes == passes and pe.activation_passes == 0
    _assert_arena_matches(je, pe, "WidePresence")
    _assert_arena_matches(je, pe, "WideGame", float_count="updates")
