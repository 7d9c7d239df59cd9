"""Differential tests of the port's workload-attribution plane against the
JAX package's (``orleans_tpu/tensor/attribution.py``, on by default there
and in the port).

Per program: the same seeded numpy inputs go through the JAX function and
the port's counterpart (the K7/K8/K9 wrappers' plain versions on the CPU).
Integer outputs must be equal exactly.  The two float32 gauges of a
snapshot, ``gini`` and ``mean_nz``, are held within ``_GAUGE_TOL``
(relative 2**-16, absolute 2**-20): JAX sums the Gini terms in float32 in
its own order, the port in float64 before one rounding, so the two differ
by the float32 rounding of a sum of up to ``cap`` terms.

Engines: twins of tests/test_attribution.py with the JAX engine's plane
on, and the slice end to end (unfused ticks, fused windows, a rollback),
compared by ``snapshot()``, ``per_key_totals()`` and the plan counters.

The installed JAX (0.9) has no ``jax.core.trace_state_clean``, which the
JAX plane's ``flush_folds`` calls; the ``jax_trace_shim`` fixture sets it
to ``jax._src.core.trace_state_clean`` for the tests that build a JAX
engine with the plane on, and undoes it after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.presence  # noqa: F401 — registers the JAX Presence grains
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.core.grain import batched_method as jax_batched_method
from orleans_tpu.tensor import Batch as JaxBatch
from orleans_tpu.tensor import Emit as JaxEmit
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import VectorGrain as JaxVectorGrain
from orleans_tpu.tensor import attribution as jattr
from orleans_tpu.tensor import field as jax_field
from orleans_tpu.tensor import vector_grain as jax_vector_grain
from orleans_tpu.tensor.vector_grain import (
    scatter_add_rows as jax_scatter_add_rows,
)
from samples.presence import run_presence_load as jax_run_presence_load

from orleans_tpu_torch.config import TensorEngineConfig
from orleans_tpu_torch.convert import (
    arena_state_from_numpy,
    attribution_state_from_numpy,
)
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.kernels import attr as kattr
from orleans_tpu_torch.samples.presence import run_presence_load
from orleans_tpu_torch.tensor import (
    Batch,
    Emit,
    TensorEngine,
    VectorGrain,
    field,
    scatter_add_rows,
    vector_grain,
)
from orleans_tpu_torch.tensor import attribution as pattr

CAP, LANES, DEPTH = 1024, 256, 4
SEEDS = pattr.CMS_SEEDS[:DEPTH]
_GAUGE_TOL = dict(rtol=2.0**-16, atol=2.0**-20)


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _lanes(seed: int, m: int = LANES, cap: int = CAP):
    """Rows with negatives, rows at and past ``cap``, int32 extremes (every
    product with a seed overflows 32 bits) and masked lanes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cap, m).astype(np.int32)
    odd = rng.random(m)
    rows[odd < 0.05] = -1
    rows[(odd >= 0.05) & (odd < 0.08)] = cap + rng.integers(0, 99)
    rows[(odd >= 0.08) & (odd < 0.1)] = np.int32(2**31 - 1)
    rows[(odd >= 0.1) & (odd < 0.12)] = np.int32(-2**31)
    valid = rng.random(m) < 0.85
    return rows, valid


def _jseeds(depth: int = DEPTH):
    return jnp.asarray(np.asarray(jattr.CMS_SEEDS[:depth], np.uint32))


# -- per program -------------------------------------------------------------

def test_constants_match_jax():
    assert pattr.CMS_SEEDS == jattr.CMS_SEEDS
    assert pattr.MAX_CMS_DEPTH == jattr.MAX_CMS_DEPTH
    for n in (0, 1, 2, 3, 1000, 1024, 1025):
        assert pattr.pow2ceil(n) == jattr.pow2ceil(n)


@pytest.mark.parametrize("width", [16, 8192])
def test_cms_hash_matches_jax(width):
    rows, _ = _lanes(1)
    rows = np.concatenate([rows, np.array([0, 1, -1, 2**31 - 1, -2**31,
                                           65536, 123456789], np.int32)])
    want = np.asarray(jattr.cms_hash(jnp.asarray(rows), _jseeds(8), width))
    got = kattr.cms_hash(_t(rows), pattr.CMS_SEEDS, width)
    np.testing.assert_array_equal(got.numpy(), want)


def _accumulators(seed: int, width: int = 64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, CAP).astype(np.int32),
            rng.integers(0, 50, (DEPTH, width)).astype(np.int32),
            rng.integers(0, 50, 64).astype(np.int32))


@pytest.mark.parametrize("width", [64, 8192])
def test_fold_batch_matches_jax(width):
    counts, cms, slots = _accumulators(2, width)
    rows, valid = _lanes(3)
    want = jattr.fold_batch(jnp.asarray(counts), jnp.asarray(cms),
                            jnp.asarray(slots), _jseeds(), jnp.int32(5),
                            jnp.asarray(rows), jnp.asarray(valid))
    got = (_t(counts), _t(cms), _t(slots))
    kattr.attr_fold(got[0], got[1], SEEDS, _t(rows), _t(valid),
                    total=got[2], slot=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fold_counts_matches_jax():
    counts, _, slots = _accumulators(4)
    rows, valid = _lanes(5)
    want = jattr.fold_counts(jnp.asarray(counts), jnp.asarray(slots),
                             jnp.int32(9), jnp.asarray(rows),
                             jnp.asarray(valid))
    got = (_t(counts), _t(slots))
    pattr.fold_counts(*got, 9, _t(rows), _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the pull-mode form (K16's count mode): the lanes grouped by row
    # under row-aligned offsets, a few lanes past the last offset
    live = np.sort(rows[(rows >= 0) & (rows < CAP)])
    seg = np.zeros(CAP + 1, np.int32)
    seg[1:] = np.cumsum(np.bincount(live, minlength=CAP))
    lanes = np.concatenate([live, np.full(5, -1, np.int32)])
    ok = valid[:len(lanes)]
    want = jattr.fold_counts(jnp.asarray(counts), jnp.asarray(slots),
                             jnp.int32(9), jnp.asarray(lanes),
                             jnp.asarray(ok), segments=jnp.asarray(seg))
    got = (_t(counts), _t(slots))
    pattr.fold_counts(*got, 9, _t(lanes), _t(ok), segments=_t(seg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fold_cms_dense_matches_jax():
    counts, cms, _ = _accumulators(6)
    delta = np.random.default_rng(7).integers(0, 4, CAP).astype(np.int32)
    delta[np.random.default_rng(8).random(CAP) < 0.5] = 0
    want = jattr.fold_cms_dense(jnp.asarray(cms), jnp.asarray(delta),
                                _jseeds())
    got_cms, got_counts = _t(cms), _t(counts)
    pattr.fold_cms_dense(got_cms, _t(delta), SEEDS, counts=got_counts)
    np.testing.assert_array_equal(got_cms.numpy(), np.asarray(want))
    # the window's form also adds the delta into the counts
    np.testing.assert_array_equal(got_counts.numpy(), counts + delta)


def test_plan_kernel_matches_jax():
    rows, valid = _lanes(9)
    want = jattr._plan_kernel(jnp.asarray(rows), jnp.asarray(valid),
                              _jseeds(), cap=CAP, width=64, depth=DEPTH)
    got = pattr._plan_kernel(_t(rows), _t(valid), SEEDS, cap=CAP, width=64,
                             depth=DEPTH)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2][0]) == int(want[2])


@pytest.mark.parametrize("device_k", [False, True])
def test_apply_coalesced_matches_jax(device_k):
    counts, cms, slots = _accumulators(10)
    rows, valid = _lanes(11)
    plan = jattr._plan_kernel(jnp.asarray(rows), jnp.asarray(valid),
                              _jseeds(), cap=CAP, width=64, depth=DEPTH)
    want = jattr._apply_coalesced(
        jnp.asarray(counts), jnp.asarray(cms), jnp.asarray(slots), plan[0],
        plan[1], jnp.int32(3), plan[2], jnp.int32(7))
    got = (_t(counts), _t(cms), _t(slots))
    k = torch.tensor([7], dtype=torch.int32) if device_k else 7
    kattr.attr_apply(got[0], _t(plan[0]), got[1], _t(plan[1]), k,
                     total=got[2], slot=3,
                     n=_t(np.asarray(plan[2]).reshape(1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pattern", ["mixed", "all_match", "all_differ"])
def test_apply_checked_stack_matches_jax(pattern):
    """k stacked entries against one plan: the JAX program stacks them
    (padded to a power of two with ``real`` masking the padding), the
    port compares them by pointer; both apply km·delta and a full fold
    per mismatch, bumping ``stale``."""
    counts, cms, slots = _accumulators(12)
    plan_rows, plan_valid = _lanes(13)
    plan = jattr._plan_kernel(jnp.asarray(plan_rows),
                              jnp.asarray(plan_valid), _jseeds(), cap=CAP,
                              width=64, depth=DEPTH)
    k = 5
    entries = []
    for e in range(k):
        differ = {"mixed": e in (1, 3), "all_match": False,
                  "all_differ": True}[pattern]
        if differ:
            r, v = _lanes(100 + e)
            if e == 3:  # same rows, one valid flag flipped
                r, v = plan_rows.copy(), plan_valid.copy()
                v[17] = ~v[17]
        else:
            r, v = plan_rows.copy(), plan_valid.copy()
        entries.append((r, v))
    pad = jattr.pow2ceil(k)
    rows_stack = np.stack([r for r, _ in entries] + [plan_rows] * (pad - k))
    valid_stack = np.stack([v for _, v in entries]
                           + [plan_valid] * (pad - k))
    want = jattr._apply_checked_stack(
        jnp.asarray(counts), jnp.asarray(cms), jnp.asarray(slots),
        jnp.zeros((), jnp.int32), jnp.asarray(plan_rows),
        jnp.asarray(plan_valid), plan[0], plan[1], plan[2], _jseeds(),
        jnp.int32(4), jnp.asarray(rows_stack), jnp.asarray(valid_stack),
        jnp.asarray(np.arange(pad) < k))
    got = (_t(counts), _t(cms), _t(slots))
    stale = torch.zeros(1, dtype=torch.int32)
    pattr._apply_checked_stack(
        *got, stale, _t(plan_rows), _t(plan_valid), _t(plan[0]),
        _t(plan[1]), _t(np.asarray(plan[2]).reshape(1)), SEEDS, 4,
        [_t(r) for r, _ in entries], [_t(v) for _, v in entries])
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(stale[0]) == int(want[3])


def test_match_counts_matches_and_flags():
    plan_rows, plan_valid = _lanes(20)
    other, _ = _lanes(21)
    rows = [_t(plan_rows), _t(other), _t(plan_rows)]
    valid = [_t(plan_valid)] * 3
    flags = torch.full((3,), 7, dtype=torch.int32)
    km = torch.zeros(1, dtype=torch.int32)
    kattr.attr_match(rows, valid, _t(plan_rows), _t(plan_valid), flags, km)
    assert flags.tolist() == [0, 1, 0] and int(km[0]) == 2


def _columns():
    rng = np.random.default_rng(30)
    p = 1.0 / np.arange(1, CAP + 1) ** 1.1
    zipf = np.bincount(np.searchsorted(np.cumsum(p / p.sum()),
                                       rng.random(20_000)),
                       minlength=CAP)[:CAP].astype(np.int32)
    sparse = np.zeros(CAP, np.int32)
    sparse[rng.choice(CAP, 40, replace=False)] = rng.integers(1, 5, 40)
    return {"all_ties": np.full(CAP, 23, np.int32),
            "zipf": rng.permutation(zipf).astype(np.int32),
            "sparse": sparse,
            "all_zero": np.zeros(CAP, np.int32),
            "tie_example": np.resize(np.array([3, 5, 5, 1, 5, 3, 5, 0],
                                              np.int32), CAP)}


@pytest.mark.parametrize("kind", list(_columns()))
@pytest.mark.parametrize("n_shards", [1, 4])
def test_snapshot_kernel_matches_jax(kind, n_shards):
    counts = _columns()[kind]
    _, cms, _ = _accumulators(31)
    k = 16
    want = jattr._snapshot_kernel(jnp.asarray(counts), jnp.asarray(cms),
                                  _jseeds(), k=k, n_shards=n_shards)
    (vals, rows, shard, total, gini, p99, mean_nz, nnz, est) = [
        np.asarray(w) for w in want]
    got = kattr.decode_snapshot(
        kattr.attr_snapshot(_t(counts), _t(cms), SEEDS, k, n_shards).numpy(),
        k, n_shards)
    # ties: lower row first, jax.lax.top_k's order
    np.testing.assert_array_equal(got["vals"], vals)
    np.testing.assert_array_equal(got["rows"], rows)
    np.testing.assert_array_equal(got["est"], est)
    np.testing.assert_array_equal(got["shard"], shard)
    assert (got["total"], got["nnz"], got["p99"]) == \
        (int(total), int(nnz), int(p99))
    np.testing.assert_allclose(got["gini"], gini, **_GAUGE_TOL)
    np.testing.assert_allclose(got["mean_nz"], mean_nz, **_GAUGE_TOL)


def test_top_k_tie_order_is_lower_row_first():
    counts = torch.tensor([3, 5, 5, 1, 5, 3, 5, 0], dtype=torch.int32)
    cms = torch.zeros((1, 16), dtype=torch.int32)
    got = kattr.decode_snapshot(kattr.attr_snapshot(counts, cms, SEEDS, 5)
                                .numpy(), 5, 1)
    assert got["rows"].tolist() == [1, 2, 4, 6, 0]


# -- engine twins of tests/test_attribution.py -------------------------------

def _jax_engine(**cfg):
    cfg.setdefault("auto_fusion_ticks", 0)
    return JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg))


def _port_engine(**cfg):
    cfg.setdefault("auto_fusion_ticks", 0)
    return TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))


def _assert_snapshots_equal(want, got):
    """Equal, except the float gauge ``gini`` within ``_GAUGE_TOL`` (and
    the 4-decimal ``p99_to_mean`` within its rounding)."""
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "arenas"} == \
        {k: v for k, v in want.items() if k != "arenas"}
    assert set(got["arenas"]) == set(want["arenas"])
    for name, w in want["arenas"].items():
        g = got["arenas"][name]
        assert set(g) == set(w), name
        for key in w:
            if key != "skew":
                assert g[key] == w[key], (name, key)
        for key, wv in w["skew"].items():
            if key == "gini":
                np.testing.assert_allclose(g["skew"][key], wv,
                                           rtol=2.0**-16, atol=2e-6)
            elif key == "p99_to_mean":
                assert abs(g["skew"][key] - wv) <= 1e-4 * (1 + abs(wv))
            else:
                assert g["skew"][key] == wv, (name, key)


def _assert_totals_equal(je, pe, type_names):
    for t in type_names:
        assert pe.attribution.per_key_totals(t) == \
            je.attribution.per_key_totals(t), t


def test_fold_matches_numpy_replay(jax_trace_shim):
    rows = np.asarray([0, 1, 1, 5, 63, -1, 99999, 2], np.int32)
    mask = np.asarray([1, 1, 1, 1, 1, 1, 1, 0], bool)
    je, pe = _jax_engine(), _port_engine()
    for eng, arr in ((je, jnp.asarray), (pe, _t)):
        arena = eng.arena_for("PresenceGrain")
        arena.resolve_rows(np.arange(64, dtype=np.int64))
        eng.attribution.record_group(arena, "PresenceGrain", "heartbeat",
                                     arr(rows), arr(mask))
        eng.attribution.flush_folds()
    att = pe.attribution
    valid = mask & (rows >= 0) & (rows < CAP)
    np.testing.assert_array_equal(
        att.counts_for("PresenceGrain").numpy(),
        np.bincount(rows[valid], minlength=CAP))
    cms = att.cms_for("PresenceGrain").numpy()
    np.testing.assert_array_equal(cms.sum(axis=1),
                                  np.full(att.cms_depth, valid.sum()))
    np.testing.assert_array_equal(
        cms, np.asarray(je.attribution.cms_for("PresenceGrain")))
    slot = att.slots.slot_for("PresenceGrain", "heartbeat")
    assert int(att._slot_arr()[slot]) == valid.sum()
    np.testing.assert_array_equal(
        att._slot_arr().numpy(), np.asarray(je.attribution._slot_arr()))


def _heartbeats(keys, n_games, tick):
    return {"game": (keys % n_games).astype(np.int32),
            "score": np.ones(len(keys), np.float32),
            "tick": np.full(len(keys), tick, np.int32)}


def test_topk_matches_host_oracle_on_zipf(jax_trace_shim, run):
    n, n_games = 2_000, 50
    rng = np.random.default_rng(7)
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    keys = np.minimum(np.searchsorted(np.cumsum(p / p.sum()),
                                      rng.random(3_000)),
                      n - 1).astype(np.int64)

    async def drive(eng):
        eng.arena_for("PresenceGrain").resolve_rows(
            np.arange(n, dtype=np.int64))
        eng.arena_for("GameGrain").resolve_rows(
            np.arange(n_games, dtype=np.int64))
        for t in range(3):
            eng.send_batch("PresenceGrain", "heartbeat", keys,
                           _heartbeats(keys, n_games, t + 1))
            await eng.drain_queues()
        await eng.flush()
        return eng.attribution.snapshot()

    je, pe = _jax_engine(), _port_engine()
    want, got = run(drive(je)), run(drive(pe))
    _assert_snapshots_equal(want, got)
    oracle = 3 * np.bincount(keys, minlength=n)
    a = got["arenas"]["PresenceGrain"]
    for h in a["hot"]:
        assert oracle[h["key"]] == h["msgs"] and h["sketch_est"] >= h["msgs"]
    assert [h["msgs"] for h in a["hot"]] == \
        np.sort(oracle)[-len(a["hot"]):][::-1].tolist()
    assert a["total_msgs"] == oracle.sum()
    assert a["skew"]["gini"] > 0.3 and a["skew"]["p99_to_mean"] > 1.0
    assert a["skew"]["hot_rows"] == int((oracle > 0).sum())
    _assert_totals_equal(je, pe, ("PresenceGrain", "GameGrain"))


def test_sketch_never_undercounts_under_collisions(jax_trace_shim):
    rows = np.random.default_rng(3).integers(0, 256, 2_000).astype(np.int32)
    sketches = []
    for eng, arr in ((_jax_engine(), jnp.asarray), (_port_engine(), _t)):
        att = eng.attribution
        att.configure(cms_width=16, cms_depth=2)
        arena = eng.arena_for("PresenceGrain")
        arena.resolve_rows(np.arange(256, dtype=np.int64))
        att.record_group(arena, "PresenceGrain", "heartbeat", arr(rows),
                         arr(np.ones(2_000, bool)))
        att.flush_folds()
        sketches.append(_np(att.cms_for("PresenceGrain")))
    np.testing.assert_array_equal(sketches[1], sketches[0])
    h = kattr.cms_hash(torch.arange(256, dtype=torch.int32), SEEDS[:2],
                       16).long().numpy()
    est = np.min(sketches[1][np.arange(2)[:, None], h], axis=0)
    assert (est >= np.bincount(rows, minlength=256)).all()


def test_growth_remap_preserves_totals(jax_trace_shim, run):
    keys = np.arange(100, dtype=np.int64)

    async def drive(eng):
        eng.arena_for("GameGrain").resolve_rows(np.arange(4, dtype=np.int64))
        arena = eng.arena_for("PresenceGrain")
        arena.resolve_rows(keys)
        cap0 = arena.capacity
        for tick in (1, 2):
            eng.send_batch("PresenceGrain", "heartbeat", keys,
                           _heartbeats(keys, 4, tick))
            await eng.drain_queues()
            await eng.flush()
            if tick == 1:
                arena.reserve(cap0 * 4)  # rows move: the counts follow
                assert arena.capacity > cap0
        return eng.attribution.per_key_totals("PresenceGrain")

    je, pe = _jax_engine(), _port_engine()
    want, got = run(drive(je)), run(drive(pe))
    assert got == want == {int(k): 2 for k in keys}
    assert pe.attribution.counts_for("PresenceGrain").shape[0] == \
        pe.arena_for("PresenceGrain").capacity


def _fuse_presence(eng, players, game, score):
    eng.arena_for("PresenceGrain").resolve_rows(players)
    eng.arena_for("GameGrain").resolve_rows(np.arange(4, dtype=np.int64))
    prog = eng.fuse_ticks("PresenceGrain", "heartbeat", players)
    return prog, {"game": game, "score": score}


def test_fused_window_counts_match(jax_trace_shim):
    players = np.arange(128, dtype=np.int64)
    snaps = []
    for eng, arr in ((_jax_engine(), jnp.asarray), (_port_engine(), _t)):
        prog, static = _fuse_presence(eng, players,
                                      arr(np.zeros(128, np.int32)),
                                      arr(np.ones(128, np.float32)))
        prog.run({"tick": arr(np.arange(1, 4, dtype=np.int32))},
                 static_args=static)
        assert prog.verify() == 0
        snaps.append(eng.attribution.snapshot())
    _assert_snapshots_equal(*snaps)
    snap = snaps[1]
    assert snap["arenas"]["PresenceGrain"]["total_msgs"] == 128 * 3
    assert snap["arenas"]["GameGrain"]["total_msgs"] == 128 * 3
    assert snap["methods"]["PresenceGrain.heartbeat"] == 128 * 3


@jax_vector_grain
class AttrTwinLwwGrain(JaxVectorGrain):
    count = jax_field(jnp.int32, 0)

    @jax_batched_method
    @staticmethod
    def put(state, batch: JaxBatch, n_rows: int):
        ones = jnp.ones_like(batch.rows, jnp.int32) * batch.mask
        return {**state, "count": jax_scatter_add_rows(
            state["count"], batch.rows, ones)}


@jax_vector_grain
class AttrTwinHopGrain(JaxVectorGrain):
    sent = jax_field(jnp.int32, 0)

    @jax_batched_method
    @staticmethod
    def send(state, batch: JaxBatch, n_rows: int):
        ones = jnp.ones_like(batch.rows, jnp.int32) * batch.mask
        state = {**state, "sent": jax_scatter_add_rows(
            state["sent"], batch.rows, ones)}
        emit = JaxEmit(interface="AttrTwinLwwGrain", method="put",
                       keys=batch.args["dst"], args={"v": batch.args["v"]},
                       mask=batch.mask)
        return state, None, (emit,)


@vector_grain
class AttrTwinLwwGrain(VectorGrain):  # noqa: F811 — the port twin
    count = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def put(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows) * batch.mask
        return {**state, "count": scatter_add_rows(state["count"],
                                                   batch.rows, ones)}


@vector_grain
class AttrTwinHopGrain(VectorGrain):  # noqa: F811 — the port twin
    sent = field(torch.int32, 0)

    @batched_method
    @staticmethod
    def send(state, batch: Batch, n_rows: int):
        ones = torch.ones_like(batch.rows) * batch.mask
        state = {**state, "sent": scatter_add_rows(state["sent"], batch.rows,
                                                   ones)}
        emit = Emit(interface="AttrTwinLwwGrain", method="put",
                    keys=batch.args["dst"], args={"v": batch.args["v"]},
                    mask=batch.mask)
        return state, None, (emit,)


def test_rollback_restores_attribution(jax_trace_shim, run):
    n, T, cold_tick = 16, 24, 18
    src = np.arange(n, dtype=np.int64)
    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4,
               auto_fusion_max_rollbacks=100)

    async def drive(eng):
        eng.arena_for("AttrTwinHopGrain").reserve(n)
        eng.arena_for("AttrTwinLwwGrain").reserve(n + 64)
        inj = eng.make_injector("AttrTwinHopGrain", "send", src)
        for t in range(T):
            dst = np.full(n, 5000 if t == cold_tick else 0, np.int32)
            inj.inject({"dst": dst, "v": np.full(n, t + 1, np.int32)})
            await eng.drain_queues()
        await eng.flush()

    je, pe = _jax_engine(**cfg), _port_engine(**cfg)
    run(drive(je))
    run(drive(pe))
    assert pe.autofuser.windows_rolled_back >= 1
    assert pe.autofuser.snapshot() == je.autofuser.snapshot()
    assert pe.attribution.per_key_totals("AttrTwinHopGrain") == \
        {k: T for k in range(n)}
    assert pe.attribution.per_key_totals("AttrTwinLwwGrain") == \
        {0: n * (T - 1), 5000: n}
    _assert_totals_equal(je, pe, ("AttrTwinHopGrain", "AttrTwinLwwGrain"))
    snap = pe.attribution.snapshot()
    assert snap["methods"]["AttrTwinHopGrain.send"] == n * T
    assert snap["methods"]["AttrTwinLwwGrain.put"] == n * T
    _assert_snapshots_equal(je.attribution.snapshot(), snap)


def test_toggle_retraces_fused_program(jax_trace_shim):
    players = np.arange(128, dtype=np.int64)
    totals = []
    for eng, arr in ((_jax_engine(), jnp.asarray), (_port_engine(), _t)):
        prog, static = _fuse_presence(eng, players,
                                      arr(np.zeros(128, np.int32)),
                                      arr(np.ones(128, np.float32)))
        seen = []
        for t0, on in ((1, True), (3, False), (5, True)):
            eng.attribution.configure(enabled=on)
            prog.run({"tick": arr(np.arange(t0, t0 + 2, dtype=np.int32))},
                     static_args=static)
            assert prog.verify() == 0
            a = eng.attribution.snapshot(cache=False)["arenas"].get(
                "PresenceGrain")
            seen.append(a["total_msgs"] if a else 0)
        totals.append(seen)
    assert totals[1] == totals[0] == [256, 256, 512]


def test_plan_memo_and_snapshot_budget(jax_trace_shim, run):
    n, n_games = 256, 8
    keys = np.arange(n, dtype=np.int64)

    async def drive(eng, arr):
        eng.arena_for("PresenceGrain").resolve_rows(keys)
        eng.arena_for("GameGrain").resolve_rows(
            np.arange(n_games, dtype=np.int64))
        inj = eng.make_injector("PresenceGrain", "heartbeat", keys)
        payload = {"game": arr((keys % n_games).astype(np.int32)),
                   "score": arr(np.ones(n, np.float32))}
        for t in range(10):
            inj.inject({**payload, "tick": np.int32(t + 1)})
            await eng.drain_queues()
        await eng.flush()
        att = eng.attribution
        st = att.stats()
        assert st["plan_builds"] <= 4, st
        assert st["plan_hits"] + st["plan_checked"] >= 16, st
        assert st["stale_folds"] == 0
        f0 = att.d2h_fetches
        first = att.snapshot()
        assert att.d2h_fetches == f0 + 1
        assert att.snapshot() is first  # cached: no new folds since
        assert att.d2h_fetches == f0 + 1
        inj.inject({**payload, "tick": np.int32(99)})
        await eng.drain_queues()
        await eng.flush()
        att.snapshot()
        assert att.d2h_fetches == f0 + 2
        return st

    want = run(drive(_jax_engine(), jnp.asarray))
    got = run(drive(_port_engine(), _t))
    # the port's eager heartbeat forwards the loader's own `game` tensor
    # as the emit's keys, a stable identity that proves the GameGrain
    # plan; the JAX emit keys are jit outputs, fresh every tick, so JAX
    # checks those folds on the device (ROADMAP queue C)
    assert got["plan_builds"] == want["plan_builds"]
    assert got["plan_hits"] + got["plan_checked"] == \
        want["plan_hits"] + want["plan_checked"]
    assert got["plan_hits"] == want["plan_hits"] + want["plan_checked"]


def test_checked_plan_stays_exact_on_changing_content(jax_trace_shim):
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 64, 32).astype(np.int32) for _ in range(5)]
    expect = sum(np.bincount(r, minlength=CAP) for r in batches)
    for eng, arr in ((_jax_engine(), jnp.asarray), (_port_engine(), _t)):
        att = eng.attribution
        arena = eng.arena_for("PresenceGrain")
        arena.resolve_rows(np.arange(64, dtype=np.int64))
        for rows in batches:  # fresh arrays each call
            att.record_group(arena, "PresenceGrain", "heartbeat",
                             arr(rows), arr(np.ones(32, bool)))
        att.flush_folds()
        np.testing.assert_array_equal(_np(att.counts_for("PresenceGrain")),
                                      expect)
        att.snapshot()
        assert att.stats()["stale_folds"] >= 1
        assert att.stats()["plan_checked"] == 4


# -- the slice as a whole ----------------------------------------------------

def _log_plans(att, log):
    """Record, per fold, (type, method, outcome, whether the auto-fuser
    was replaying buffered ticks)."""
    record = att.record_group

    def logged(arena, type_name, method, rows, mask, ident=None, **kw):
        before = (att.plan_hits, att.plan_checked, att.plan_builds)
        record(arena, type_name, method, rows, mask, ident=ident, **kw)
        after = (att.plan_hits, att.plan_checked, att.plan_builds)
        outcome = "hit" if after[0] > before[0] else \
            "checked" if after[1] > before[1] else "built"
        log.append((type_name, method, outcome,
                    att.engine.autofuser._replaying))

    att.record_group = logged


async def _moving_load(eng, n_players, n_games, ticks, cold_at):
    """Presence with the games a fresh host array every tick (a per-tick
    leaf); from tick ``cold_at`` player 0 moves to a game no one has
    activated, so the window that holds it misses and rolls back."""
    rng = np.random.default_rng(5)
    games = rng.integers(0, n_games, n_players).astype(np.int32)
    scores = rng.random(n_players, dtype=np.float32)
    eng.arena_for("PresenceGrain").reserve(n_players)
    eng.arena_for("GameGrain").reserve(n_games + 8)
    inj = eng.make_injector("PresenceGrain", "heartbeat",
                            np.arange(n_players, dtype=np.int64))
    for t in range(ticks):
        g = games.copy()
        if t >= cold_at:
            g[0] = n_games + 3
        inj.inject({"game": g, "score": scores, "tick": np.int32(t + 1)})
        await eng.drain_queues()
    await eng.flush()


@pytest.mark.parametrize("load", ["run_presence_load", "moving_rollback"])
def test_presence_slice_matches_jax(jax_trace_shim, run, load):
    """Both engines at their defaults (attribution on, auto-fusion after 3
    identical ticks, 4-tick windows): unfused ticks, fused windows and,
    for ``moving_rollback``, one forced rollback.  Snapshots, per-key
    totals and the fold outcome of every record (built, hit or checked)
    must agree: the port's injector carries the device key mirror that
    anchors the JAX plan, and a buffered tick replayed unfused carries
    the injector's rows but not that mirror, in both packages."""
    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4,
               auto_fusion_verify_windows=2)
    logs = {}

    async def drive(eng, side):
        logs[side] = []
        _log_plans(eng.attribution, logs[side])
        if load == "run_presence_load":
            await (jax_run_presence_load if side == "jax"
                   else run_presence_load)(
                eng, n_players=256, n_games=8, n_ticks=24, seed=3,
                warm_ticks=3, device_payloads=False)
        else:
            await _moving_load(eng, 256, 8, ticks=30, cold_at=22)

    je = JaxTensorEngine(config=JaxEngineConfig(tick_interval=0.0, **cfg))
    pe = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))
    run(drive(je, "jax"))
    run(drive(pe, "port"))
    af = pe.autofuser.snapshot()
    assert af == je.autofuser.snapshot()
    assert af["windows_run"] >= 2
    if load == "moving_rollback":
        assert af["windows_rolled_back"] == 1
    _assert_snapshots_equal(je.attribution.snapshot(),
                            pe.attribution.snapshot())
    _assert_totals_equal(je, pe, ("PresenceGrain", "GameGrain"))
    assert sum(pe.attribution.per_key_totals("GameGrain").values()) == \
        pe.ledger.snapshot()["GameGrain.update_game_status"]["total"]
    jlog, plog = logs["jax"], logs["port"]
    assert [x[:3] for x in plog] == [x[:3] for x in jlog]
    for key in ("plan_builds", "stale_folds"):
        assert pe.attribution.stats()[key] == je.attribution.stats()[key]


def test_plan_not_proven_after_in_place_rewrite(jax_trace_shim, run):
    """A loader that rewrites its ``game`` tensor (the emit's keys, the
    GameGrain plan's anchor) in place must not get the old plan applied
    by identity: the version counter moved, so the fold is checked on
    the device, and the counts equal JAX's with fresh arrays each tick."""
    n, n_games = 64, 4
    keys = np.arange(n, dtype=np.int64)
    games = [(keys + t) % n_games for t in range(4)]

    async def drive(eng, in_place):
        eng.arena_for("PresenceGrain").resolve_rows(keys)
        eng.arena_for("GameGrain").resolve_rows(
            np.arange(n_games, dtype=np.int64))
        inj = eng.make_injector("PresenceGrain", "heartbeat", keys)
        game = _t(games[0].astype(np.int32))
        score = torch.ones(n, dtype=torch.float32)
        for t, g in enumerate(games):
            if in_place is None:  # the JAX engine: a new array each tick
                game, score = jnp.asarray(g.astype(np.int32)), jnp.ones(n)
            elif in_place:
                game.copy_(_t(g.astype(np.int32)))
            else:
                game = _t(g.astype(np.int32))
            inj.inject({"game": game, "score": score, "tick": np.int32(t)})
            await eng.drain_queues()
            await eng.flush()
        return eng.attribution.per_key_totals("GameGrain")

    rewritten = _port_engine()
    want = {g: int(sum((gs == g).sum() for gs in games))
            for g in range(n_games)}
    assert run(drive(_jax_engine(), None)) == want
    assert run(drive(rewritten, True)) == want
    assert run(drive(_port_engine(), False)) == want
    st = rewritten.attribution.stats()
    assert st["plan_hits"] == 3 and st["plan_checked"] == 3, st


def test_flush_deferred_while_capturing(monkeypatch):
    """A flush inside a CUDA-graph capture would be recorded and replayed
    with every window: ``flush_folds`` leaves the buffer alone while the
    stream is capturing, and the first flush after it applies it once."""
    eng = _port_engine()
    att = eng.attribution
    arena = eng.arena_for("PresenceGrain")
    arena.resolve_rows(np.arange(8, dtype=np.int64))
    rows = torch.arange(8, dtype=torch.int32)
    att.record_group(arena, "PresenceGrain", "heartbeat", rows,
                     torch.ones(8, dtype=torch.bool))
    monkeypatch.setattr(pattr, "_capturing", lambda: True)
    att.flush_folds()
    assert att.stats()["pending_folds"] == 1
    assert int(att.counts_for("PresenceGrain").sum()) == 0
    monkeypatch.setattr(pattr, "_capturing", lambda: False)
    att.flush_folds()
    assert att.stats()["pending_folds"] == 0
    assert att.counts_for("PresenceGrain")[:8].tolist() == [1] * 8


def test_attribution_carried_across_matches_jax(jax_trace_shim, run):
    """``convert.attribution_state_from_numpy`` carries a JAX engine's
    plane (counts, sketches, slots, retired mirror) into a port engine
    whose arenas were carried across: both then report the same
    snapshot and per-key totals, and fold the next tick the same way."""
    kw = dict(n_players=256, n_games=8, n_ticks=3, seed=4)
    je = _jax_engine()
    run(jax_run_presence_load(je, **kw))
    jatt = je.attribution
    jatt.flush_folds()
    pe = _port_engine()
    for name in ("PresenceGrain", "GameGrain"):
        ja = je.arena_for(name)
        arena_state_from_numpy(pe.arena_for(name), ja._key_of_row,
                               {k: np.asarray(v)
                                for k, v in ja.state.items()})
    slot_names = [k for k, _ in sorted(jatt.slots.items(),
                                       key=lambda kv: kv[1])]
    attribution_state_from_numpy(
        pe.attribution, slot_names,
        counts={t: np.asarray(c) for t, c in jatt._counts.items()},
        cms={t: np.asarray(s) for t, s in jatt._cms.items()},
        slot_counts=np.asarray(jatt._slot_arr()),
        retired={t: dict(d) for t, d in jatt._retired.items()},
        retired_rows=jatt.retired_rows)
    _assert_snapshots_equal(jatt.snapshot(), pe.attribution.snapshot())
    _assert_totals_equal(je, pe, ("PresenceGrain", "GameGrain"))
    players = np.arange(256, dtype=np.int64)

    async def tick(eng):
        eng.send_batch("PresenceGrain", "heartbeat", players,
                       _heartbeats(players, 8, 9))
        await eng.flush()

    for eng in (je, pe):
        run(tick(eng))
    _assert_snapshots_equal(jatt.snapshot(), pe.attribution.snapshot())
    _assert_totals_equal(je, pe, ("PresenceGrain", "GameGrain"))
