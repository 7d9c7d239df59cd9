"""Differential tests of the port's durable state plane against the JAX
package, at one shard block.

K19 ``pin_columns``, K20 ``gather_columns`` and K21 ``dirty_mask`` (their
plain versions here) against the JAX programs they replace —
``_pin_tree``, ``_gather_tree``, ``_dirty_mask_kernel`` and
``_touched_mask_kernel`` — bit for bit.  Then twins of
tests/test_durability.py, of ``test_kill_recover_spanning_promoted_interval``
(tests/test_replication.py) and of the VectorStore checkpoint cases of
tests/test_tensor_persistence.py: each scenario runs on a JAX engine and on
a port engine on ``device="cpu"``, from the same numpy draws, and the
recovered arenas are compared row for row across the packages — the
key→row map, the bump pointer, the free list as a set, generation,
eviction epoch, every state column, both use clocks — besides each
scenario's own oracle.  Integer and float columns alike must be equal: a
restore is a copy, and every replayed fold here is an integer one.  A
recovery point the JAX package wrote (a full, deltas and sealed journal
segments, in memory and on disk) must restore into the port equal to the
JAX package's own recovery.

Port-only cases cover what a JAX array cannot do: a tensor rewritten in
place after it was journaled (replay applies the enqueue-time values), live
ticks between a snapshot's pin and its last drain slice (the snapshot holds
the cut), and a fused window built before a recovery point's adoption
(it rebuilds under the cause ``restore`` and equals the unfused run).

Not twinned here: the chaos invariant checker and the chaos kill scenario
(``orleans_tpu.chaos``), the silo's startup recovery, graceful stop and
metrics publication, and the perfgate family — they need a port silo and
chaos harness (host integration, ROADMAP queue A item 8).  The contract of
tests/test_durability.py:533 is twinned without the checker: a manifest
naming a deleted blob makes ``recover()`` raise in both packages.  The
composed case of tests/test_durability.py:807 runs at one shard block,
without the migrated pins (multi-shard slice, item 7).

The installed JAX lacks ``jax.core.trace_state_clean``, which the JAX
attribution plane's flush calls: the ``jax_trace_shim`` fixture sets it
per test.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.banking as jax_banking
import samples.presence  # noqa: F401 — registers the JAX presence grains
import tests.test_durability  # noqa: F401 — registers JAX DuraCounter
import tests.test_replication  # noqa: F401 — registers JAX ReplCounter
import tests.test_tensor_engine  # noqa: F401 — registers JAX AccumGrain
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import FileSnapshotStore as JaxFileSnapshotStore
from orleans_tpu.tensor import MemorySnapshotStore as JaxMemorySnapshotStore
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor import checkpoint as jax_ckpt
from orleans_tpu.tensor.arena import _pow2_pad
from orleans_tpu.tensor.persistence import FileVectorStore as JaxFileVS

import orleans_tpu_torch.samples.presence  # noqa: F401 — port presence
import tests.test_torch_presence  # noqa: F401 — registers port AccumGrain
import tests.test_torch_replication  # noqa: F401 — registers ReplCounter
from orleans_tpu_torch.config import TensorEngineConfig
from orleans_tpu_torch.core.grain import batched_method, commutative
from orleans_tpu_torch.kernels import checkpoint as kck
from orleans_tpu_torch.samples import banking as port_banking
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor import checkpoint as port_ckpt
from orleans_tpu_torch.tensor.fused import CAUSE_NEW_WINDOW, CAUSE_RESTORE
from orleans_tpu_torch.tensor.persistence import FileVectorStore
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    scatter_add_rows,
    seg_sum,
    vector_grain,
    vector_type,
)


@pytest.fixture
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


if vector_type("DuraCounter") is None:
    @vector_grain
    class DuraCounter(VectorGrain):
        total = field(torch.int32, 0)

        @batched_method
        @staticmethod
        @commutative
        def bump(state, batch: Batch, n_rows: int):
            return {**state, "total": state["total"]
                    + seg_sum(batch.args["amount"], batch.rows, n_rows)}

    @vector_grain
    class DuraTimerProbe(VectorGrain):
        fires = field(torch.int32, 0)

        @batched_method
        @staticmethod
        def receive_reminder(state, batch: Batch, n_rows: int):
            ones = batch.mask.to(torch.int32)
            return {"fires": scatter_add_rows(state["fires"], batch.rows,
                                              ones)}

        @batched_method
        @staticmethod
        def poke(state, batch: Batch, n_rows: int):
            return state


# -- the two sides -----------------------------------------------------------

J = types.SimpleNamespace(
    name="jax", Engine=JaxTensorEngine, banking=jax_banking,
    Store=JaxMemorySnapshotStore, FileStore=JaxFileSnapshotStore,
    ckpt=jax_ckpt, kw={},
    cfg=lambda **kw: JaxEngineConfig(tick_interval=0.0, **kw),
    col=lambda c: np.asarray(c), clock=lambda a: a.last_use_tick,
    stats=lambda e: e.snapshot())
P = types.SimpleNamespace(
    name="port", Engine=TensorEngine, banking=port_banking,
    Store=port_ckpt.MemorySnapshotStore,
    FileStore=port_ckpt.FileSnapshotStore, ckpt=port_ckpt,
    kw={"device": "cpu"}, cfg=lambda **kw: TensorEngineConfig(**kw),
    col=lambda c: c.cpu().numpy(), clock=lambda a: a.host_clock(),
    stats=lambda e: e.stats())
SIDES = (J, P)


def _engine(s, backing=None, store=None, **cfg):
    cfg.setdefault("auto_fusion_ticks", 0)
    if store is None and backing is not None:
        store = s.Store(backing)
    return s.Engine(config=s.cfg(**cfg), snapshot_store=store, **s.kw)


def _both(run, scenario, *args, **kw):
    """The scenario's results on the JAX side and on the port side."""
    return run(scenario(J, *args, **kw)), run(scenario(P, *args, **kw))


def _assert_arenas(ja, pa, s_a=J, s_b=P):
    """Two arenas (any sides) hold the same identity and state."""
    assert pa.capacity == ja.capacity
    np.testing.assert_array_equal(pa._key_of_row, ja._key_of_row)
    np.testing.assert_array_equal(np.asarray(pa._shard_next),
                                  np.asarray(ja._shard_next))
    assert set(np.concatenate(pa._free).tolist()) \
        == set(np.concatenate(ja._free).tolist())
    for attr in ("generation", "eviction_epoch", "live_count"):
        assert getattr(pa, attr) == getattr(ja, attr), attr
    assert {int(k): list(map(int, v)) for k, v in pa._replicas.items()} \
        == {int(k): list(map(int, v)) for k, v in ja._replicas.items()}
    for name, col in ja.state.items():
        np.testing.assert_array_equal(s_b.col(pa.state[name]),
                                      s_a.col(col), err_msg=name)
    np.testing.assert_array_equal(s_b.col(pa.last_use_dev),
                                  s_a.col(ja.last_use_dev))
    live = ja._key_of_row >= 0
    np.testing.assert_array_equal(s_b.clock(pa)[live], s_a.clock(ja)[live])


def _assert_engines(je, pe, type_names):
    for t in type_names:
        _assert_arenas(je.arena_for(t), pe.arena_for(t))


def _drive_presence(engine, keys, games, n_ticks, start=0):
    inj = engine.make_injector("PresenceGrain", "heartbeat", keys)
    for t in range(start, start + n_ticks):
        inj.inject({"game": games,
                    "score": np.ones(len(keys), np.float32),
                    "tick": np.int32(t + 1)})
        engine.run_tick()


def _send(s, engine, ev):
    args = {"amount": ev["amount"]}
    if ev["method"] == "transfer":
        args["dst"] = ev["dst"]
    engine.send_batch("AccountGrain", ev["method"], ev["keys"], args)


def _acked(engine, lanes):
    sites = engine.checkpointer.journal.sites
    return sum(s.committed_lanes for s in sites.values()) // lanes


def _touched_keys(events):
    return np.unique(np.concatenate(
        [np.concatenate([e["keys"], e.get("dst", np.empty(0, np.int64))])
         for e in events])).astype(np.int64)


def _accounts(s, engine, keys):
    arena = engine.arena_for("AccountGrain")
    rows, found = arena.lookup_rows(np.asarray(keys, dtype=np.int64))
    assert found.all()
    return {n: s.col(arena.state[n])[rows]
            for n in ("balance", "credits", "debits")}


def _assert_oracle(s, engine, oracle, keys):
    got, want = _accounts(s, engine, keys), oracle.expect(keys)
    for name in ("balance", "credits", "debits"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# -- K19–K21 against the JAX programs ----------------------------------------

def _tree(rng, n):
    return {"a": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "f": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(0, 9, (n, 3)).astype(np.int32),
            "b": rng.random(n) < 0.5,
            "__last_use_dev": rng.integers(0, 100, n).astype(np.int32)}


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_pin_and_gather_match_jax_programs(n):
    """K19's and K20's plain versions equal ``_pin_tree`` and
    ``_gather_tree`` bit for bit: int32, float32, a ``[n, 3]`` and a bool
    column plus the clock; pad lanes read row 0 and rows past the end
    clip, as ``_pow2_pad`` and the JAX gather's clamping give."""
    rng = np.random.default_rng(n)
    tree = _tree(rng, n)
    names = list(tree)
    cols = [torch.from_numpy(tree[k]) for k in names]
    want_pin = jax_ckpt._pin_tree({k: jnp.asarray(v)
                                   for k, v in tree.items()})
    got_pin = kck.pin_columns(cols)
    for k, g in zip(names, got_pin):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want_pin[k]))
        assert g.data_ptr() != dict(zip(names, cols))[k].data_ptr()
    rows = rng.integers(0, n, max(1, n // 3)).astype(np.int32)
    rows[:1] = n - 1
    idx = _pow2_pad(rows, 0)
    want = jax_ckpt._gather_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                 jnp.asarray(idx))
    staging, views = kck.gather_columns(cols, torch.from_numpy(idx))
    host = kck.fetch_packed(staging, cols, len(idx))
    for k, v, h in zip(names, views, host):
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(h, np.asarray(want[k]))
    # the packed layout: 16-byte aligned offsets inside one buffer
    offs, size = kck.packed_layout(cols, len(idx))
    assert all(o % 16 == 0 for o in offs) and size == staging.numel()
    # rows past the end and negative rows clip, as the JAX gather clamps
    wild = np.array([-5, n, n + 100, 0], np.int32)
    _s, views = kck.gather_columns(cols, torch.from_numpy(wild))
    for k, v in zip(names, views):
        np.testing.assert_array_equal(
            v.numpy(), tree[k][np.clip(wild, 0, n - 1)])


@pytest.mark.parametrize("mode", ["dirty", "touched"])
def test_dirty_mask_matches_jax_programs(mode):
    """K21's plain version equals ``_dirty_mask_kernel`` (dirty mode) and
    ``_touched_mask_kernel`` (counts None), clocks equal to the cutoff
    among the rows, and the cutoff at the clipped int32 edges."""
    rng = np.random.default_rng(21)
    n = 5000
    counts = rng.integers(0, 4, n).astype(np.int32)
    pinned = np.where(rng.random(n) < 0.2, counts + 1, counts) \
        .astype(np.int32)
    dev = rng.integers(0, 60, n).astype(np.int32)
    host = rng.integers(0, 60, n).astype(np.int32)
    live = rng.random(n) < 0.8
    t = {k: torch.from_numpy(v) for k, v in
         dict(counts=counts, pinned=pinned, dev=dev, host=host,
              live=live).items()}
    for cutoff in (30, 0, 59, -2**31 + 1, 2**31 - 1):
        assert ((np.maximum(dev, host) == cutoff).any()
                or cutoff not in (30, 59))
        if mode == "dirty":
            want = jax_ckpt._dirty_mask_kernel(
                jnp.asarray(counts), jnp.asarray(pinned), jnp.asarray(dev),
                jnp.asarray(host), jnp.asarray(live), jnp.int32(cutoff))
            got = kck.dirty_mask(t["counts"], t["pinned"], t["dev"],
                                 t["host"], t["live"], cutoff)
        else:
            want = jax_ckpt._touched_mask_kernel(
                jnp.asarray(dev), jnp.asarray(host), jnp.asarray(live),
                jnp.int32(cutoff))
            got = kck.dirty_mask(None, None, t["dev"], t["host"], t["live"],
                                 cutoff)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_journal_device_leaf_dedupe_and_copy():
    """A device leaf is copied on append (K19), and the same tensor
    presented again unchanged is stored once per segment; written in
    place in between, it is stored again."""
    eng = _engine(P, {})
    eng.register_journal("AccountGrain", "deposit")
    j = eng.checkpointer.journal
    amount = torch.arange(8, dtype=torch.int32)
    keys = np.arange(8, dtype=np.int64)

    class B:
        keys_host = keys
        keys_dev = None
        inject_tick = 1
        args = {"amount": amount}

    j.append("AccountGrain", "deposit", B)
    j.append("AccountGrain", "deposit", B)
    site = j.sites[("AccountGrain", "deposit")]
    assert len(site.dev_arrays) == 1 and len(site.host_arrays) == 1
    assert site.dev_arrays[0].data_ptr() != amount.data_ptr()
    amount.add_(100)
    j.append("AccountGrain", "deposit", B)
    assert len(site.dev_arrays) == 2
    np.testing.assert_array_equal(site.dev_arrays[0].numpy(), np.arange(8))
    np.testing.assert_array_equal(site.dev_arrays[1].numpy(),
                                  np.arange(8) + 100)


# -- twins of tests/test_durability.py ----------------------------------------

async def _full_restore(s):
    backing = {}
    eng = _engine(s, backing)
    keys = np.arange(300, dtype=np.int64)
    games = (keys % 7).astype(np.int32)
    _drive_presence(eng, keys, games, 6)
    await eng.flush()
    arena = eng.arena_for("PresenceGrain")
    arena.evict_keys(keys[250:], write_back=False)
    eng.checkpointer.checkpoint_full()
    eng2 = _engine(s, backing)
    stats = await eng2.checkpointer.recover()
    assert stats["recovered"]
    _assert_arenas(arena, eng2.arena_for("PresenceGrain"), s, s)
    return eng2


def test_full_checkpoint_restores_state_and_identity(run, jax_trace_shim):
    """tests/test_durability.py:69: a sealed full restores per-key state,
    row ids, generation, eviction epoch and the free list exactly."""
    je, pe = _both(run, _full_restore)
    _assert_engines(je, pe, ("PresenceGrain", "GameGrain"))


async def _journal_fold(s, n_accounts=200, n_ticks=20, seed=7):
    backing = {}
    lanes = 64
    events = s.banking.make_events(n_accounts, n_ticks, lanes=lanes,
                                   seed=seed)
    eng = _engine(s, backing, journal_flush_every_ticks=3)
    s.banking.register_banking_journal(eng)
    eng.checkpointer.checkpoint_full()
    # no final flush: the kill lands with lanes pending
    for ev in events:
        _send(s, eng, ev)
        eng.run_tick()
    acked = _acked(eng, lanes)
    assert 0 < acked < len(events)
    eng2 = _engine(s, backing, journal_flush_every_ticks=4)
    stats = await eng2.checkpointer.recover()
    assert stats["replayed_lanes"] == acked * lanes
    oracle = s.banking.BankOracle(n_accounts)
    for ev in events[:acked]:
        oracle.apply(ev)
    touched = _touched_keys(events[:acked])
    _assert_oracle(s, eng2, oracle, touched)
    a2 = eng2.arena_for("AccountGrain")
    rows, found = a2.lookup_rows(np.arange(n_accounts, dtype=np.int64))
    assert int(s.col(a2.state["balance"])[rows[found]].sum()) \
        == oracle.total()
    return eng2, acked, stats


def test_journal_fold_replay_bit_exact_vs_uninterrupted(run, jax_trace_shim):
    """tests/test_durability.py:109: the sealed journal tail replays to
    the acknowledged prefix exactly, the transfer's credit leg rebuilt by
    re-execution; the port equals the JAX package and an uninterrupted
    port engine fed the acknowledged prefix."""
    (je, jacked, jstats), (pe, packed, pstats) = _both(run, _journal_fold)
    assert jacked == packed
    for k in ("replayed_lanes", "replayed_ticks", "fused_windows",
              "fused_lanes", "recovery_tick"):
        assert pstats[k] == jstats[k], k
    _assert_engines(je, pe, ("AccountGrain",))
    events = port_banking.make_events(200, 20, lanes=64, seed=7)
    oracle_eng = _engine(P)
    run(port_banking.run_banking_load(oracle_eng, events[:packed]))
    touched = _touched_keys(events[:packed])
    want = _accounts(P, oracle_eng, touched)
    got = _accounts(P, pe, touched)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


async def _delta_composes(s):
    backing = {}
    eng = _engine(s, backing)
    keys = np.arange(400, dtype=np.int64)
    games = (keys % 5).astype(np.int32)
    _drive_presence(eng, keys, games, 4)
    await eng.flush()
    eng.checkpointer.checkpoint_full()
    rows_before = eng.checkpointer.rows_written
    _drive_presence(eng, keys[:50], games[:50], 3, start=10)
    await eng.flush()
    r = eng.checkpointer.checkpoint_delta()
    assert r["kind"] == "delta"
    delta_rows = eng.checkpointer.rows_written - rows_before
    assert 50 <= delta_rows <= 60
    eng2 = _engine(s, backing)
    await eng2.checkpointer.recover()
    for t in ("PresenceGrain", "GameGrain"):
        _assert_arenas(eng.arena_for(t), eng2.arena_for(t), s, s)
    return eng2, delta_rows, eng.checkpointer.last_dirty_rows


def test_delta_checkpoint_selects_moved_rows_and_composes(run,
                                                          jax_trace_shim):
    """tests/test_durability.py:173: only the touched rows re-write, and
    full + delta compose into the live state; the port selects the same
    dirty rows as the JAX package."""
    (je, jrows, jdirty), (pe, prows, pdirty) = _both(run, _delta_composes)
    assert (prows, pdirty) == (jrows, jdirty)
    _assert_engines(je, pe, ("PresenceGrain", "GameGrain"))


async def _delta_slot_reuse(s):
    backing = {}
    eng = _engine(s, backing)
    n = 120
    events = s.banking.make_events(n, 6, lanes=48, seed=3, transfer_every=0)
    s.banking.register_banking_journal(eng)
    await s.banking.run_banking_load(eng, events)
    eng.checkpointer.checkpoint_full()
    arena = eng.arena_for("AccountGrain")
    victim = int(events[0]["keys"][0])
    victim_row = int(arena.lookup_rows(np.array([victim], np.int64))[0][0])
    arena.evict_keys(np.array([victim], np.int64), write_back=False)
    newcomer = np.int64(n + 999)
    await s.banking.run_banking_load(eng, [{
        "method": "deposit", "keys": np.array([newcomer], np.int64),
        "amount": np.array([17], np.int32)}])
    rows, found = arena.lookup_rows(np.array([newcomer]))
    assert found[0] and int(rows[0]) == victim_row  # the slot was reused
    eng.checkpointer.checkpoint_delta()
    eng2 = _engine(s, backing)
    await eng2.checkpointer.recover()
    a2 = eng2.arena_for("AccountGrain")
    np.testing.assert_array_equal(a2._key_of_row, arena._key_of_row)
    assert not a2.lookup_rows(np.array([victim], np.int64))[1][0]
    got = _accounts(s, eng2, np.array([newcomer]))
    assert int(got["balance"][0]) == 17 and int(got["credits"][0]) == 1
    return eng2


def test_delta_exact_under_evict_and_slot_reuse(run, jax_trace_shim):
    """tests/test_durability.py:210: an evicted key's slot reused by
    another key between checkpoints restores to the newcomer alone."""
    je, pe = _both(run, _delta_slot_reuse)
    _assert_engines(je, pe, ("AccountGrain",))


async def _generation_promotes(s):
    eng = _engine(s, {})
    keys = np.arange(64, dtype=np.int64)
    _drive_presence(eng, keys, (keys % 4).astype(np.int32), 3)
    await eng.flush()
    eng.checkpointer.checkpoint_full()
    fulls0 = eng.checkpointer.full_snapshots
    eng.arena_for("PresenceGrain").resolve_rows(
        np.arange(64, 3000, dtype=np.int64), tick=5)
    r = eng.checkpointer.checkpoint_delta()
    return (r["kind"], eng.checkpointer.full_snapshots - fulls0,
            eng.checkpointer.delta_snapshots, r["rows"])


def test_generation_change_promotes_delta_to_full(run, jax_trace_shim):
    """tests/test_durability.py:252: growth between checkpoints promotes
    the next delta to a full."""
    jr, pr = _both(run, _generation_promotes)
    assert pr == jr == ("full", 1, 0, jr[3])


async def _fused_recovers(s):
    backing = {}
    n = 150
    rng = np.random.default_rng(11)
    keys = np.arange(n, dtype=np.int64)
    amounts = [rng.integers(1, 50, n).astype(np.int32) for _ in range(24)]
    cfg = dict(auto_fusion_ticks=4, auto_fusion_window=4,
               journal_flush_every_ticks=6)
    eng = _engine(s, backing, **cfg)
    s.banking.register_banking_journal(eng)
    eng.checkpointer.checkpoint_full()
    inj = eng.make_injector("AccountGrain", "deposit", keys)
    for a in amounts:
        inj.inject({"amount": a})
        eng.run_tick()
    await eng.flush()
    fused = s.stats(eng)["autofuse"]["windows_run"]
    assert fused > 0
    acked = _acked(eng, n)
    assert 0 < acked <= len(amounts)
    eng2 = _engine(s, backing, **cfg)
    await eng2.checkpointer.recover()
    want = np.zeros(n, np.int64)
    for a in amounts[:acked]:
        want += a
    got = _accounts(s, eng2, keys)
    np.testing.assert_array_equal(got["balance"], want)
    np.testing.assert_array_equal(got["credits"], np.full(n, acked))
    return eng2, acked, fused


def test_fused_run_recovers_bit_exact(run, jax_trace_shim):
    """tests/test_durability.py:276: the journal rides auto-fused windows,
    and the committed horizon restores exactly."""
    (je, jacked, jfused), (pe, packed, pfused) = _both(run, _fused_recovers)
    assert (packed, pfused) == (jacked, jfused)
    _assert_engines(je, pe, ("AccountGrain",))


def test_journal_non_lane_device_leaf_appends_and_replays():
    """tests/test_durability.py:325: a device leaf whose first dimension
    differs from the lane count (a per-batch table) appends like any
    device leaf; a scalar rides the entry's metadata.  Both packages
    decode the same entry."""
    decoded = []
    for s, dev in ((J, jnp.asarray), (P, torch.as_tensor)):
        eng = _engine(s, {})
        eng.register_journal("PresenceGrain", "heartbeat")
        eng.checkpointer.checkpoint_full()
        keys = np.arange(16, dtype=np.int64)

        class FakeBatch:
            keys_host = keys
            keys_dev = None
            inject_tick = 3
            args = {"game": dev(np.zeros(16, np.int32)),
                    "table": dev(np.arange(7, dtype=np.int32)),
                    "tick": np.int32(4)}

        eng.checkpointer.journal.append("PresenceGrain", "heartbeat",
                                        FakeBatch)
        eng.checkpointer.journal.flush()
        store = eng.checkpointer.store
        seg = store.read_manifest()["journal"][
            "PresenceGrain.heartbeat"]["segments"][-1]
        arrays, meta = store.get_blob(seg["blob"])
        e = s.ckpt.DeviceJournal.decode_segment(arrays, meta)[-1]
        np.testing.assert_array_equal(e["keys"], keys)
        np.testing.assert_array_equal(e["args"]["game"], np.zeros(16))
        np.testing.assert_array_equal(e["args"]["table"], np.arange(7))
        assert int(e["args"]["tick"]) == 4
        decoded.append((meta["skeleton"], meta["entries"]))
    assert decoded[0] == decoded[1]


async def _delta_clocks(s):
    backing = {}
    eng = _engine(s, backing)
    keys = np.arange(100, dtype=np.int64)
    _drive_presence(eng, keys, (keys % 4).astype(np.int32), 3)
    await eng.flush()
    eng.checkpointer.checkpoint_full()
    arena = eng.arena_for("PresenceGrain")
    eng.tick_number += 500
    hot = keys[:20]
    arena.resolve_rows(hot, tick=eng.tick_number)
    r = eng.checkpointer.checkpoint_delta()
    assert r["kind"] == "delta"
    eng2 = _engine(s, backing)
    await eng2.checkpointer.recover()
    a2 = eng2.arena_for("PresenceGrain")
    hot_rows = arena.lookup_rows(hot)[0]
    np.testing.assert_array_equal(s.clock(a2)[hot_rows],
                                  s.clock(arena)[hot_rows])
    assert int(s.clock(a2)[hot_rows].min()) >= 500
    return eng2


def test_delta_restore_applies_recorded_use_clocks(run, jax_trace_shim):
    """tests/test_durability.py:369: a delta records the full host use
    clock at its cut and the restore applies it."""
    je, pe = _both(run, _delta_clocks)
    _assert_engines(je, pe, ("PresenceGrain",))


async def _cadence(s):
    eng = _engine(s, {}, ckpt_full_every_ticks=12, ckpt_delta_every_ticks=4,
                  ckpt_pause_budget_s=0.002, journal_flush_every_ticks=3)
    s.banking.register_banking_journal(eng)
    events = s.banking.make_events(100, 40, lanes=32, seed=5)
    await s.banking.run_banking_load(eng, events)
    ck = eng.checkpointer
    assert ck.full_snapshots >= 1 and ck.delta_snapshots >= 1
    assert ck.journal.segments_committed >= 1
    assert 0 <= ck.age_ticks() <= 3 * 12
    snap = s.stats(eng)["durability"]
    assert snap["enabled"] and snap["rows_written"] > 0
    return (ck.full_snapshots, ck.delta_snapshots,
            ck.journal.segments_committed, ck.rows_written, ck.age_ticks(),
            ck.journal.snapshot()["sites"])


def test_periodic_cadence_commits_under_live_traffic(run, jax_trace_shim):
    """tests/test_durability.py:401: fulls, deltas and journal seals
    commit on the tick cadence while traffic flows — the same counts and
    the same rows as the JAX package."""
    jr, pr = _both(run, _cadence)
    assert pr == jr


async def _ring_overflow(s):
    eng = _engine(s, {}, journal_ring_lanes=128)
    s.banking.register_banking_journal(eng)
    events = s.banking.make_events(50, 10, lanes=48, seed=9,
                                   transfer_every=0)
    await s.banking.run_banking_load(eng, events)
    j = eng.checkpointer.journal
    assert j.ring_overflows > 0
    site = j.sites[("AccountGrain", "deposit")]
    assert site.appended_lanes == 10 * 48
    assert site.appended_lanes == site.committed_lanes + site.segment_lanes
    return j.ring_overflows, j.snapshot()["sites"]


def test_journal_ring_overflow_seals_midtick_without_loss(run,
                                                          jax_trace_shim):
    """tests/test_durability.py:426: a full site seals its open segment
    instead of dropping or raising."""
    jr, pr = _both(run, _ring_overflow)
    assert pr == jr


async def _file_store(s, root, events):
    eng = _engine(s, store=s.FileStore(root))
    s.banking.register_banking_journal(eng)
    await s.banking.run_banking_load(eng, events)
    eng.checkpointer.checkpoint_full()
    store = s.FileStore(root)
    good = store.read_manifest()
    assert good is not None
    real_replace = os.replace

    def boom(src, dst):
        if dst.endswith("MANIFEST.json"):
            raise OSError("injected kill mid-commit")
        return real_replace(src, dst)

    os.replace = boom
    try:
        with pytest.raises(OSError):
            store.commit_manifest({"seq": 10**6, "recovery": None})
    finally:
        os.replace = real_replace
    assert store.read_manifest() == good


async def _recover_from(s, store):
    eng = _engine(s, store=store)
    stats = await eng.checkpointer.recover()
    assert stats["recovered"]
    return eng


def test_file_snapshot_store_roundtrip_and_atomic_manifest(run, tmp_path,
                                                           jax_trace_shim):
    """tests/test_durability.py:447: a kill → recover round trip through
    real files, and a crash inside a manifest commit leaves the previous
    recovery point readable.  The directory the JAX package wrote
    restores into the port equal to the JAX package's own recovery."""
    events = jax_banking.make_events(80, 8, lanes=32, seed=2)
    oracle = jax_banking.BankOracle(80)
    for ev in events:
        oracle.apply(ev)
    touched = _touched_keys(events)
    roots = {s.name: str(tmp_path / s.name) for s in SIDES}
    for s in SIDES:
        run(_file_store(s, roots[s.name], events))
    je = run(_recover_from(J, J.FileStore(roots["jax"])))
    pe = run(_recover_from(P, P.FileStore(roots["port"])))
    cross = run(_recover_from(P, P.FileStore(roots["jax"])))
    for s, e in ((J, je), (P, pe), (P, cross)):
        _assert_oracle(s, e, oracle, touched)
    _assert_engines(je, pe, ("AccountGrain",))
    _assert_engines(je, cross, ("AccountGrain",))


def test_file_vector_store_torn_write_leaves_prior_record(tmp_path):
    """tests/test_durability.py:496: an exception mid-columnar-write
    leaves the previously committed record readable and no temp file;
    the JAX package reads the port's records."""
    store = FileVectorStore(str(tmp_path / "rows"))
    keys = [1, 2, 3]
    store.write_many_columnar("Acct", keys,
                              {"balance": np.array([10, 20, 30], np.int32)})
    calls = {"n": 0}
    real_savez = np.savez

    def flaky(f, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("injected kill mid-write")
        return real_savez(f, **kw)

    np.savez = flaky
    try:
        with pytest.raises(OSError):
            store.write_many_columnar(
                "Acct", keys, {"balance": np.array([11, 21, 31], np.int32)})
    finally:
        np.savez = real_savez
    out = store.read_many("Acct", keys)
    assert [int(out[k]["balance"]) for k in keys] == [11, 20, 30]
    d = str(tmp_path / "rows" / "Acct")
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    jout = JaxFileVS(str(tmp_path / "rows")).read_many("Acct", keys)
    assert {k: int(v["balance"]) for k, v in jout.items()} \
        == {k: int(v["balance"]) for k, v in out.items()}
    np.testing.assert_array_equal(store.list_keys("Acct"), keys)


async def _missing_blob(s):
    backing = {}
    eng = _engine(s, backing)
    s.banking.register_banking_journal(eng)
    await s.banking.run_banking_load(
        eng, s.banking.make_events(40, 4, lanes=16, seed=1))
    eng.checkpointer.checkpoint_full()
    manifest = eng.checkpointer.store.read_manifest()
    eng.checkpointer.store.delete_blob(
        manifest["recovery"]["full"]["arenas"]["AccountGrain"]["parts"][0])
    with pytest.raises(RuntimeError, match="missing snapshot blob"):
        await _engine(s, backing).checkpointer.recover()


def test_recover_raises_on_missing_blob(run, jax_trace_shim):
    """The contract of tests/test_durability.py:533 without the chaos
    checker: a manifest naming a deleted blob is an error at recovery,
    never a silent skip, in both packages."""
    _both(run, _missing_blob)


async def _fused_fold(s):
    backing = {}
    n_accounts, lanes = 300, 64
    events = s.banking.make_events(n_accounts, 30, lanes=lanes, seed=29)
    eng = _engine(s, backing, journal_flush_every_ticks=4)
    s.banking.register_banking_journal(eng)
    eng.checkpointer.checkpoint_full()
    for ev in events:
        _send(s, eng, ev)
        eng.run_tick()
    acked = _acked(eng, lanes)
    assert 0 < acked < len(events)
    oracle = s.banking.BankOracle(n_accounts)
    for ev in events[:acked]:
        oracle.apply(ev)
    eng2 = _engine(s, backing, journal_flush_every_ticks=4)
    s.banking.register_banking_journal(eng2)
    st2 = await eng2.checkpointer.recover()
    assert st2["replayed_lanes"] == acked * lanes
    assert st2["fused_windows"] > 0 and st2["fused_lanes"] > 0
    eng3 = _engine(s, backing, journal_flush_every_ticks=4,
                   recover_fused_window=1)
    s.banking.register_banking_journal(eng3)
    st3 = await eng3.checkpointer.recover()
    assert st3["fused_windows"] == 0
    assert st3["replayed_lanes"] == acked * lanes
    touched = _touched_keys(events[:acked])
    _assert_oracle(s, eng2, oracle, touched)
    _assert_oracle(s, eng3, oracle, touched)
    return eng2, st2, eng3


def test_fused_fold_replay_matches_per_tick_and_oracle(run, jax_trace_shim):
    """tests/test_durability.py:747: stacked fold-replay windows equal the
    per-tick replay and the oracle, and fusion engages — the same windows
    as the JAX package; the ledger and the attribution plane end equal."""
    (je2, jst, je3), (pe2, pst, pe3) = _both(run, _fused_fold)
    for k in ("replayed_lanes", "fused_windows", "fused_lanes",
              "replayed_ticks"):
        assert pst[k] == jst[k], k
    _assert_engines(je2, pe2, ("AccountGrain",))
    _assert_engines(je3, pe3, ("AccountGrain",))
    for je, pe in ((je2, pe2), (je3, pe3)):
        assert pe.attribution.per_key_totals("AccountGrain") \
            == je.attribution.per_key_totals("AccountGrain")


async def _rollback_replay(s):
    """Fold-replay without the emit-key hints: transfer windows miss on
    cold credit destinations, roll back and replay tick by tick."""
    backing = {}
    lanes = 64
    events = s.banking.make_events(300, 12, lanes=lanes, seed=31)
    eng = _engine(s, backing, journal_flush_every_ticks=4)
    s.banking.register_banking_journal(eng)
    eng.checkpointer.checkpoint_full()
    for ev in events:
        _send(s, eng, ev)
        eng.run_tick()
    acked = _acked(eng, lanes)
    oracle = s.banking.BankOracle(300)
    for ev in events[:acked]:
        oracle.apply(ev)
    eng2 = _engine(s, backing)
    st = await eng2.checkpointer.recover()
    _assert_oracle(s, eng2, oracle, _touched_keys(events[:acked]))
    return eng2, st


def test_replay_rollback_restores_ledger_and_attribution(run,
                                                         jax_trace_shim):
    """A fold-replay window that misses (a cold emit destination) rolls
    back the state, the counters, the latency ledger and the attribution
    plane (``restore_state``) before replaying tick by tick: the port
    ends equal to the JAX package in all of them."""
    (je, jst), (pe, pst) = _both(run, _rollback_replay)
    assert pst["fused_windows"] == jst["fused_windows"] == 0 \
        < pst["replayed_ticks"]
    assert pst["replayed_lanes"] == jst["replayed_lanes"]
    _assert_engines(je, pe, ("AccountGrain",))
    assert pe.tick_number == je.tick_number
    assert pe.messages_processed == je.messages_processed
    assert pe.attribution.per_key_totals("AccountGrain") \
        == je.attribution.per_key_totals("AccountGrain")
    want, got = je.ledger.snapshot(), pe.ledger.snapshot()
    assert want and {k: (v["counts"], v["total"]) for k, v in got.items()} \
        == {k: (v["counts"], v["total"]) for k, v in want.items()}


async def _standby(s):
    backing = {}
    n_accounts, lanes = 200, 64
    events = s.banking.make_events(n_accounts, 24, lanes=lanes, seed=13)
    primary = _engine(s, backing, ckpt_full_every_ticks=8,
                      ckpt_delta_every_ticks=4, ckpt_pause_budget_s=0.002,
                      journal_flush_every_ticks=3)
    s.banking.register_banking_journal(primary)
    standby = _engine(s)
    s.banking.register_banking_journal(standby)
    tailer = s.ckpt.StandbyTailer(standby, s.Store(backing))
    for i, ev in enumerate(events):
        _send(s, primary, ev)
        primary.run_tick()
        if i % 4 == 3:
            tailer.poll()
    await primary.flush()
    assert tailer.lag_ticks() >= 0
    assert tailer.adopted_rows > 0
    acked = _acked(primary, lanes)
    assert 0 < acked <= len(events)
    oracle = s.banking.BankOracle(n_accounts)
    for ev in events[:acked]:
        oracle.apply(ev)
    res = await tailer.promote(owner="standby-1")
    assert res["promoted"] and tailer.promoted and res["fence_epoch"] >= 1
    assert standby.checkpointer.promotions == 1
    _assert_oracle(s, standby, oracle, _touched_keys(events[:acked]))
    with pytest.raises(s.ckpt.FencedError):
        primary.checkpointer.checkpoint_full()
    assert primary.checkpointer.fenced
    standby.send_batch("AccountGrain", "deposit",
                       np.arange(8, dtype=np.int64),
                       {"amount": np.ones(8, np.int32)})
    standby.run_tick()
    await standby.flush()
    anchor = standby.checkpointer.checkpoint_full()
    assert anchor["rows"] > 0
    return standby, {k: res[k] for k in ("fence_epoch", "adopted_tick",
                                         "adopted_rows", "replayed_lanes",
                                         "fused_windows")}


def test_standby_tails_promotes_and_fences(run, jax_trace_shim):
    """tests/test_durability.py:888: the tailer adopts fulls and deltas
    and stages sealed segments while traffic runs; promotion fences the
    store, replays only the un-adopted tail and lands exactly at the
    acknowledged prefix; the old primary can never commit again."""
    (je, jres), (pe, pres) = _both(run, _standby)
    assert pres == jres
    _assert_engines(je, pe, ("AccountGrain",))


async def _composed(s):
    backing = {}
    cfg = dict(ckpt_full_every_ticks=10, ckpt_delta_every_ticks=5,
               ckpt_pause_budget_s=0.002, journal_flush_every_ticks=3)
    eng = _engine(s, backing, **cfg)
    eng.register_journal("DuraCounter", "bump")
    rng = np.random.default_rng(23)
    keys = np.arange(96, dtype=np.int64)
    tkeys = np.arange(32, dtype=np.int64)
    inj = eng.make_injector("DuraTimerProbe", "poke", tkeys)
    inj.inject({})
    eng.run_tick()
    due = eng.tick_number + 60
    eng.timers.arm_batch("DuraTimerProbe", tkeys, np.full(32, due, np.int64),
                         0, "close")
    amounts_by_tick = []
    for t in range(25):
        amounts = rng.integers(1, 100, 96).astype(np.int32)
        amounts_by_tick.append(amounts)
        eng.send_batch("DuraCounter", "bump", keys, {"amount": amounts})
        eng.run_tick()
        if t == 5:
            assert eng.replicate_key("DuraCounter", 7, 3) == 3
    await eng.flush()
    assert eng.arenas["DuraCounter"]._replicas
    acked = _acked(eng, 96)
    assert 0 < acked < 25
    oracle = np.zeros(96, dtype=np.int64)
    for amounts in amounts_by_tick[:acked]:
        oracle += amounts
    eng2 = _engine(s, backing, **cfg)
    stats = await eng2.checkpointer.recover()
    assert stats["recovered"] and stats["fused_windows"] == 0
    a2 = eng2.arenas["DuraCounter"]
    got = np.array([int(a2.read_row(int(k))["total"]) for k in keys])
    np.testing.assert_array_equal(got, oracle)
    assert eng2.timers.armed_total == 32
    recovered = {n: s.col(c).copy() for n, c in a2.state.items()}
    while eng2.tick_number < due:
        eng2.run_tick()
    await eng2.flush()
    ta = eng2.arena_for("DuraTimerProbe")
    fires = s.col(ta.state["fires"])[ta.lookup_rows(tkeys)[0]]
    assert (fires == 1).all(), fires
    for _ in range(8):
        eng2.run_tick()
    await eng2.flush()
    fires = s.col(ta.state["fires"])[ta.lookup_rows(tkeys)[0]]
    assert (fires == 1).all(), "timer fired twice"
    return eng2, recovered, stats["replayed_lanes"]


def test_composed_recovery_replication_and_timers(run, jax_trace_shim):
    """tests/test_durability.py:807 at one shard block, without migrated
    pins: a kill spanning a promoted replica interval with armed timers —
    the replica folds equal the acknowledged-prefix oracle, the armed
    set survives, and each timer fires exactly once after recovery."""
    (je, jstate, jlanes), (pe, pstate, planes) = _both(run, _composed)
    assert planes == jlanes
    for name in jstate:
        np.testing.assert_array_equal(pstate[name], jstate[name])
    _assert_engines(je, pe, ("DuraCounter", "DuraTimerProbe"))


async def _promoted_interval(s):
    backing = {}
    cfg = dict(ckpt_full_every_ticks=10, ckpt_delta_every_ticks=5,
               ckpt_pause_budget_s=0.002, journal_flush_every_ticks=3)
    eng = _engine(s, backing, **cfg)
    eng.register_journal("ReplCounter", "bump")
    rng = np.random.default_rng(31)
    keys = np.arange(96, dtype=np.int64)
    amounts_by_tick = []
    for t in range(29):
        amounts = rng.integers(1, 100, 96).astype(np.int32)
        amounts_by_tick.append(amounts)
        eng.send_batch("ReplCounter", "bump", keys, {"amount": amounts})
        eng.run_tick()
        if t == 8:
            assert eng.replicate_key("ReplCounter", 11, 3) == 3
    await eng.flush()
    acked = _acked(eng, 96)
    assert 8 < acked < 29
    oracle = np.zeros(96, dtype=np.int64)
    for amounts in amounts_by_tick[:acked]:
        oracle += amounts
    eng2 = _engine(s, backing, **cfg)
    stats = await eng2.checkpointer.recover()
    assert stats["recovered"]
    await eng2.flush()
    arena2 = eng2.arenas["ReplCounter"]
    assert set(arena2._replicas) == {11} and len(arena2._replicas[11]) == 3

    def totals():
        return np.array([int(arena2.read_row(int(k))["total"])
                         for k in keys])

    np.testing.assert_array_equal(totals(), oracle)
    state = {n: s.col(c).copy() for n, c in arena2.state.items()}
    assert eng2.demote_key("ReplCounter", 11) == 2
    np.testing.assert_array_equal(totals(), oracle)
    return eng2, state


def test_kill_recover_spanning_promoted_interval(run, jax_trace_shim):
    """tests/test_replication.py:242 at one shard block: the cut carries
    the replica group, a fresh engine restores it, journal replay spreads
    across it, and the fold (and a later demote) equals the oracle."""
    (je, jstate), (pe, pstate) = _both(run, _promoted_interval)
    for name in jstate:
        np.testing.assert_array_equal(pstate[name], jstate[name])
    _assert_engines(je, pe, ("ReplCounter",))


# -- twins of tests/test_tensor_persistence.py (VectorStore checkpoint) -------

def _add(engine, keys, v):
    engine.send_batch("AccumGrain", "add", np.asarray(keys, dtype=np.int64),
                      {"v": np.full(len(keys), v, np.float32)})


async def _vs_checkpoint(s, root, FVS):
    engine = s.Engine(store=FVS(root), initial_capacity=64, **s.kw)
    _add(engine, range(20), 7.0)
    await engine.flush()
    assert await engine.checkpoint() == 20
    engine2 = s.Engine(store=FVS(root), initial_capacity=64, **s.kw)
    assert engine2.restore(["AccumGrain"]) == 20
    arena2 = engine2.arena_for("AccumGrain")
    assert arena2.live_count == 20
    assert float(arena2.read_row(13)["total"]) == 7.0
    _add(engine2, [13], 1.0)
    await engine2.flush()
    assert float(arena2.read_row(13)["total"]) == 8.0
    return engine2


def test_checkpoint_restore_into_fresh_engine(run, tmp_path, jax_trace_shim):
    """tests/test_tensor_persistence.py:171: every live row written
    through a FileVectorStore comes back in a fresh engine, and traffic
    continues on top of it — the same arena as the JAX package's."""
    je = run(_vs_checkpoint(J, str(tmp_path / "j"), JaxFileVS))
    pe = run(_vs_checkpoint(P, str(tmp_path / "p"), FileVectorStore))
    _assert_engines(je, pe, ("AccumGrain",))


async def _vs_default_types(s, root, FVS):
    engine = s.Engine(store=FVS(root), initial_capacity=32, **s.kw)
    _add(engine, range(5), 2.0)
    await engine.flush()
    await engine.checkpoint()
    engine2 = s.Engine(store=FVS(root), initial_capacity=32, **s.kw)
    assert engine2.restore() >= 5
    assert engine2.arena_for("AccumGrain").live_count == 5
    return engine2


def test_restore_defaults_to_registered_types(run, tmp_path, jax_trace_shim):
    """tests/test_tensor_persistence.py:271: ``restore()`` with no
    argument walks the vector-grain registry, not the (empty) arenas."""
    je = run(_vs_default_types(J, str(tmp_path / "j"), JaxFileVS))
    pe = run(_vs_default_types(P, str(tmp_path / "p"), FileVectorStore))
    _assert_engines(je, pe, ("AccumGrain",))


# -- a recovery point written by the JAX package -------------------------------

async def _jax_writes(backing):
    """The JAX package writes a full, deltas and sealed journal segments
    (banking journaled, presence checkpointed only) and is killed."""
    eng = _engine(J, backing, journal_flush_every_ticks=3)
    jax_banking.register_banking_journal(eng)
    keys = np.arange(200, dtype=np.int64)
    games = (keys % 9).astype(np.int32)
    _drive_presence(eng, keys, games, 3)
    events = jax_banking.make_events(120, 14, lanes=32, seed=41)
    await jax_banking.run_banking_load(eng, events[:4])
    eng.checkpointer.checkpoint_full()
    _drive_presence(eng, keys[:40], games[:40], 2, start=5)
    await jax_banking.run_banking_load(eng, events[4:8])
    eng.checkpointer.checkpoint_delta()
    eng.arena_for("AccountGrain").evict_keys(events[0]["keys"][:3],
                                             write_back=False)
    await jax_banking.run_banking_load(eng, events[8:10])
    eng.checkpointer.checkpoint_delta()
    for ev in events[10:]:
        _send(J, eng, ev)
        eng.run_tick()
    return eng


def test_jax_written_recovery_point_restores_into_port(run, jax_trace_shim):
    """A MemorySnapshotStore backing the JAX package wrote — a full, two
    deltas (one across an eviction) and sealed journal segments —
    recovers into the port equal to the JAX package's own recovery, in
    identity, state, both clocks and the replayed tail."""
    backing = {}
    run(_jax_writes(backing))
    manifest = JaxMemorySnapshotStore(backing).read_manifest()
    assert len(manifest["recovery"]["deltas"]) == 2
    assert manifest["journal"]
    je = _engine(J, backing)
    jst = run(je.checkpointer.recover())
    pe = _engine(P, backing)
    pst = run(pe.checkpointer.recover())
    for k in ("recovery_tick", "restored_rows", "replayed_lanes",
              "replayed_ticks", "fused_windows"):
        assert pst[k] == jst[k], k
    assert pst["replayed_lanes"] > 0
    _assert_engines(je, pe, ("PresenceGrain", "GameGrain", "AccountGrain"))
    assert pe.tick_number == je.tick_number


# -- what a tensor can do and a JAX array cannot -------------------------------

@pytest.mark.parametrize("path", ["send_batch", "inject"])
def test_journal_replays_enqueue_time_values_after_in_place_rewrite(run,
                                                                    path):
    """A caller rewrites its tensor in place after handing it over (the
    injector's slab, refreshed before the next tick; a send_batch
    payload): the journal copied it on append, so replay applies the
    enqueue-time values and the recovered state equals the live one."""
    async def main():
        backing = {}
        eng = _engine(P, backing, journal_flush_every_ticks=2)
        port_banking.register_banking_journal(eng)
        eng.checkpointer.checkpoint_full()
        keys = np.arange(64, dtype=np.int64)
        amount = torch.ones(64, dtype=torch.int32)
        inj = eng.make_injector("AccountGrain", "deposit", keys)
        for t in range(9):
            if path == "inject":
                inj.inject({"amount": amount})
                eng.run_tick()
                amount.add_(t + 1)  # after the tick applied it
            else:
                eng.send_batch("AccountGrain", "deposit", keys,
                               {"amount": amount})
                amount.add_(t + 1)  # before the tick reads it
                eng.run_tick()
        await eng.flush()
        eng.checkpointer.journal.flush()
        live = _accounts(P, eng, keys)
        eng2 = _engine(P, backing)
        st = await eng2.checkpointer.recover()
        assert st["replayed_lanes"] == 9 * 64
        got = _accounts(P, eng2, keys)
        for name in live:
            np.testing.assert_array_equal(got[name], live[name])
        # the enqueue-time values 1, 2, 4, 7, ..., not the last one 9 times
        steps = [1]
        for t in range(8):
            steps.append(steps[-1] + t + 1)
        np.testing.assert_array_equal(got["balance"],
                                      np.full(64, sum(steps)))

    run(main())


def test_snapshot_holds_the_cut_across_live_ticks(run):
    """Live ticks between ``begin`` (the K19 pin) and the last drain slice
    update the columns in place; the committed snapshot is still the
    cut's state, never a later one."""
    async def main():
        backing = {}
        eng = _engine(P, backing, ckpt_chunk_rows=16,
                      ckpt_pause_budget_s=1e-9)
        keys = np.arange(300, dtype=np.int64)
        games = (keys % 7).astype(np.int32)
        _drive_presence(eng, keys, games, 3)
        await eng.flush()
        eng.checkpointer.begin("full")
        cut = {t: {n: c.clone() for n, c in eng.arena_for(t).state.items()}
               for t in ("PresenceGrain", "GameGrain")}
        cut_clock = eng.arena_for("PresenceGrain").last_use_dev.clone()
        queued = len(eng.checkpointer._active.queue)
        _drive_presence(eng, keys, games, 4, start=50)
        assert eng.checkpointer._active is not None
        assert len(eng.checkpointer._active.queue) < queued  # slices ran
        assert not torch.equal(
            eng.arena_for("PresenceGrain").state["heartbeats"],
            cut["PresenceGrain"]["heartbeats"])
        eng.checkpointer.run_slice(0.0)
        assert eng.checkpointer._active is None
        eng2 = _engine(P, backing)
        await eng2.checkpointer.recover()
        for t, cols in cut.items():
            for n, c in cols.items():
                assert torch.equal(eng2.arena_for(t).state[n], c), (t, n)
        assert torch.equal(eng2.arena_for("PresenceGrain").last_use_dev,
                           cut_clock)

    run(main())


def test_fused_window_rebuilds_after_adoption(run):
    """A fused window built before a recovery point's adoption (the warm
    standby re-basing onto the primary's full) rebuilds under the cause
    ``restore`` — the adoption brings back the recorded generation, so
    the generation alone could not tell — and its result equals the
    unfused run on the adopted state."""
    async def main():
        backing = {}
        keys = np.arange(48, dtype=np.int64)
        primary = _engine(P, backing)
        port_banking.register_banking_journal(primary)
        await port_banking.run_banking_load(
            primary, port_banking.make_events(48, 6, lanes=48, seed=5,
                                              transfer_every=0))
        primary.checkpointer.checkpoint_full()
        standby = _engine(P)
        oracle_eng = _engine(P)
        # the standby's own traffic first: a different layout
        rev = keys[::-1].copy()
        await port_banking.run_banking_load(standby, [
            {"method": "deposit", "keys": rev,
             "amount": np.full(48, 3, np.int32)}])
        prog = standby.fuse_ticks("AccountGrain", "deposit", keys)
        stacked = {"amount": np.ones((4, 48), np.int32)}
        prog.run(stacked)
        assert prog.verify() == 0
        gen = standby.arena_for("AccountGrain").generation
        tailer = port_ckpt.StandbyTailer(standby,
                                         port_ckpt.MemorySnapshotStore(backing))
        tailer.poll()
        oracle_tailer = port_ckpt.StandbyTailer(
            oracle_eng, port_ckpt.MemorySnapshotStore(backing))
        oracle_tailer.poll()
        assert standby.arena_for("AccountGrain").generation == gen
        prog.run(stacked)
        assert prog.verify() == 0
        assert prog.rebuilds[CAUSE_RESTORE] == 1
        assert prog.rebuilds[CAUSE_NEW_WINDOW] == 1
        for _ in range(4):
            oracle_eng.send_batch("AccountGrain", "deposit", keys,
                                  {"amount": np.ones(48, np.int32)})
            oracle_eng.run_tick()
        await oracle_eng.flush()
        got, want = (_accounts(P, e, keys) for e in (standby, oracle_eng))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])

    run(main())


def test_timers_cut_no_longer_raises():
    """The port's timers plane exports, restores and finishes a cut like
    the JAX plane; the restored timers then move out by export_keys (the
    cross-silo handoff's ride-along) and arm again by adopt_keys."""
    eng = _engine(P, {})
    eng.timers.arm_batch("DuraTimerProbe", np.arange(4, dtype=np.int64),
                         np.full(4, 9, np.int64), 0, "t")
    arrays, meta = eng.timers.export_cut("delta")  # incomplete → full
    assert meta["kind"] == "full" and len(arrays["0:keys"]) == 4
    eng.timers.cancel("DuraTimerProbe", 2, "t")
    arrays_d, meta_d = eng.timers.export_cut("delta")
    assert meta_d["kind"] == "delta" and list(arrays_d["op"]) == [1]
    eng2 = _engine(P, {})
    eng2.timers.restore_entry(arrays, meta)
    eng2.timers.restore_entry(arrays_d, meta_d)
    eng2.timers.finish_restore(0)
    assert eng2.timers.armed_total == 3
    moved = eng2.timers.export_keys("DuraTimerProbe", np.arange(2))
    assert moved["keys"] == [0, 1] and moved["remaining"] == [9, 9]
    assert eng2.timers.armed_total == 1
    assert eng.timers.adopt_keys("DuraTimerProbe", moved) == 2


def test_recover_without_manifest_is_a_no_op(run):
    assert run(_engine(P, {}).checkpointer.recover())["recovered"] is False
    assert run(_engine(P).checkpointer.recover())["recovered"] is False


def test_pin_waits_for_the_fusers_buffered_ticks(run):
    """A cut is not pinned while the auto-fuser still holds buffered
    ticks: they were journaled at injection with the tick clock of then
    (a fused stretch does not advance it), so a pin taken while a flush
    replays them one by one would let the later ones run after the cut
    with stamps before it — dropped by the replay filter and pruned at
    the next full, though acknowledged.  Every acknowledged deposit
    survives the kill."""
    async def main():
        backing = {}
        n = 64
        cfg = dict(auto_fusion_ticks=4, auto_fusion_window=4,
                   ckpt_full_every_ticks=6, journal_flush_every_ticks=2)
        eng = _engine(P, backing, **cfg)
        port_banking.register_banking_journal(eng)
        keys = np.arange(n, dtype=np.int64)
        rng = np.random.default_rng(5)
        amounts = [rng.integers(1, 50, n).astype(np.int32)
                   for _ in range(26)]
        inj = eng.make_injector("AccountGrain", "deposit", keys)
        for a in amounts:
            inj.inject({"amount": a})
            eng.run_tick()
        await eng.flush()  # replays the partial window tick by tick
        assert eng.autofuser.snapshot()["windows_run"] > 0
        assert eng.checkpointer.full_snapshots == 1
        acked = _acked(eng, n)
        assert acked == len(amounts)
        eng2 = _engine(P, backing, **cfg)
        await eng2.checkpointer.recover()
        got = _accounts(P, eng2, keys)
        np.testing.assert_array_equal(got["balance"],
                                      np.sum(amounts[:acked], axis=0))
        np.testing.assert_array_equal(got["credits"], np.full(n, acked))

    run(main())


def test_fused_windows_after_recover_equal_unfused(run):
    """Auto-fused windows on a recovered engine (their program built, and
    counted, over the adopted columns) end equal to an unfused engine
    recovered from the same point and fed the same ticks."""
    async def main():
        backing = {}
        keys = np.arange(96, dtype=np.int64)
        eng = _engine(P, backing, journal_flush_every_ticks=2)
        port_banking.register_banking_journal(eng)
        await port_banking.run_banking_load(
            eng, port_banking.make_events(96, 9, lanes=64, seed=8))
        eng.checkpointer.checkpoint_full()
        rng = np.random.default_rng(4)
        amounts = [rng.integers(1, 9, 96).astype(np.int32)
                   for _ in range(24)]
        ends = []
        for fuse in (4, 0):
            e2 = _engine(P, backing, auto_fusion_ticks=fuse,
                         auto_fusion_window=4)
            await e2.checkpointer.recover()
            inj = e2.make_injector("AccountGrain", "deposit", keys)
            for a in amounts:
                inj.inject({"amount": a})
                e2.run_tick()
            await e2.flush()
            ends.append(e2)
        fused, unfused = ends
        assert fused.autofuser.snapshot()["windows_run"] > 0
        assert sum(p.rebuilds[CAUSE_NEW_WINDOW]
                   for p in fused.autofuser._programs.values()) >= 1
        got, want = (_accounts(P, e, keys) for e in (fused, unfused))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])

    run(main())
