"""The port's clustered vector data plane against the JAX package's, on the
CPU: silos of one process over the in-process transport with wire
fidelity, ring ownership, slab shipping, the miss path's remote shipping,
the handoff fence and the ring-change migration push, and K22's plain
version.

Each differential test drives one scenario through a JAX
``TestingCluster`` and a port ``TestingCluster`` (engines on the CPU) and
compares the cluster-wide union of arena rows key by key: integer columns
exactly, float columns within ``FLOAT_TOL``.  The two clusters split their
keys differently — a silo's ring points hash its generation, which comes
from a counter of each package — so ownership is compared per side (no
key live on two silos, every silo holding some), and separately on rings
built from equal (host, port, generation) triples.

The installed JAX (0.9) lacks ``jax.core.trace_state_clean``, which the
JAX attribution plane's flush calls on every eviction (a handoff evicts):
the ``jax_trace_shim`` fixture sets it per test.
"""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import samples.presence  # noqa: F401 — registers the JAX presence grains
import tests.test_torch_fused  # noqa: F401 — TwinHopGrain, TwinLwwGrain
import tests.test_vector_router  # noqa: F401 — JAX RouteCounter, FenceGrain
from orleans_tpu.config import SiloConfig as JaxSiloConfig
from orleans_tpu.hashing import ring_hash_int_keys as jax_ring_hash_int_keys
from orleans_tpu.ids import GrainId as JaxGrainId
from orleans_tpu.ids import SiloAddress as JaxSiloAddress
from orleans_tpu.runtime import messaging as jax_messaging
from orleans_tpu.runtime.ring import VirtualBucketsRing as JaxRing
from orleans_tpu.runtime.runtime_client import CallbackData as JaxCallback
from orleans_tpu.tensor.engine import BatchInjector as JaxBatchInjector
from orleans_tpu.tensor.fanout import DeviceFanout as JaxFanout
from orleans_tpu.tensor.persistence import MemoryVectorStore as JaxMVS
from orleans_tpu.tensor.router import _gather_args_dev
from orleans_tpu.testing.cluster import TestingCluster as JaxCluster
from samples.presence import run_presence_load as jax_presence_load

import orleans_tpu_torch.samples.presence  # noqa: F401 — port presence
from orleans_tpu_torch.config import SiloConfig
from orleans_tpu_torch.core.grain import batched_method
from orleans_tpu_torch.hashing import ring_hash_int_keys
from orleans_tpu_torch.ids import GrainId, SiloAddress
from orleans_tpu_torch.kernels import router as krouter
from orleans_tpu_torch.runtime import messaging as port_messaging
from orleans_tpu_torch.runtime.ring import VirtualBucketsRing
from orleans_tpu_torch.runtime.runtime_client import CallbackData
from orleans_tpu_torch.samples.presence import run_presence_load
from orleans_tpu_torch.tensor.engine import BatchInjector
from orleans_tpu_torch.tensor.fanout import DeviceFanout
from orleans_tpu_torch.tensor.router import ClusterInjector
from orleans_tpu_torch.tensor.vector_grain import (
    Batch,
    VectorGrain,
    field,
    seg_sum,
    vector_grain,
    vector_type,
)
from orleans_tpu_torch.testing import TestingCluster

# float32 fan-in sums of a few ones per row: both sides exact in practice;
# the tolerance covers a reordered atomic sum
FLOAT_TOL = 1e-5

N_PLAYERS, N_GAMES, N_TICKS = 2000, 20, 20


@pytest.fixture(autouse=True)
def jax_trace_shim(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


if vector_type("RouteCounter") is None:
    @vector_grain
    class RouteCounter(VectorGrain):
        total = field(torch.float32, 0.0)
        count = field(torch.int32, 0)

        @batched_method
        @staticmethod
        def add(state, batch: Batch, n_rows: int):
            state = {
                **state,
                "total": state["total"] + seg_sum(batch.args["v"],
                                                  batch.rows, n_rows),
                "count": state["count"] + seg_sum(
                    (batch.rows >= 0).to(torch.int32), batch.rows, n_rows),
            }
            return state, {"echo": batch.args["v"] * 2}, ()

    @vector_grain
    class FenceGrain(VectorGrain):
        hits = field(torch.int32, 0)
        notes = field(torch.int32, 0)

        @batched_method
        @staticmethod
        def ping(state, batch: Batch, n_rows: int):
            ones = batch.mask.to(torch.int32)
            return {**state, "hits": state["hits"]
                    + seg_sum(ones, batch.rows, n_rows)}

        @batched_method
        @staticmethod
        def note(state, batch: Batch, n_rows: int):
            ones = batch.mask.to(torch.int32)
            return {**state, "notes": state["notes"]
                    + seg_sum(ones, batch.rows, n_rows)}


# -- the two sides -----------------------------------------------------------

def _fast(cfg):
    cfg.liveness.probe_period = 0.1
    cfg.liveness.probe_timeout = 0.1
    cfg.liveness.num_missed_probes_limit = 2
    cfg.liveness.table_refresh_timeout = 0.2
    cfg.liveness.iam_alive_table_publish = 0.5
    return cfg


def _jax_cluster(n, store=False, tune=None, setup=None):
    backing = JaxMVS.shared_backing()

    def cfg(name):
        c = _fast(JaxSiloConfig(name=name))
        if tune is not None:
            tune(c)
        return c

    def silo_setup(silo):
        if store:
            silo.tensor_engine.store = JaxMVS(backing)
        if setup is not None:
            setup(silo)

    return JaxCluster(n_silos=n, config_factory=cfg, silo_setup=silo_setup)


def _port_cluster(n, store=False, tune=None, setup=None):
    def cfg(name):
        c = _fast(SiloConfig(name=name))
        if tune is not None:
            tune(c)
        return c

    return TestingCluster(n_silos=n, config_factory=cfg, silo_setup=setup,
                          device="cpu", store_backing={} if store else None)


J = types.SimpleNamespace(
    name="jax", cluster=_jax_cluster, Fanout=JaxFanout,
    keys_dev=lambda n: jnp.arange(n, dtype=jnp.int32),
    vals=lambda a: jnp.asarray(a), msg=jax_messaging, Callback=JaxCallback,
    GrainId=JaxGrainId, presence=jax_presence_load,
    Injector=JaxBatchInjector)
P = types.SimpleNamespace(
    name="port", cluster=_port_cluster, Fanout=DeviceFanout,
    keys_dev=lambda n: torch.arange(n, dtype=torch.int32),
    vals=lambda a: torch.from_numpy(np.asarray(a)), msg=port_messaging,
    Callback=CallbackData, GrainId=GrainId, presence=run_presence_load,
    Injector=BatchInjector)


def arena_rows(cluster, type_name):
    """{key: (silo name, row)} across the cluster; asserts no key is live
    on two silos (the single-activation invariant)."""
    seen = {}
    for silo in cluster.silos:
        arena = silo.tensor_engine.arenas.get(type_name)
        if arena is None:
            continue
        for k in arena.keys():
            assert int(k) not in seen, \
                f"key {k} active on {seen[int(k)][0]} AND {silo.name}"
            seen[int(k)] = (silo.name, {
                n: np.asarray(v) for n, v in arena.read_row(int(k)).items()})
    return seen


def assert_same_rows(want, got):
    """Cluster-wide rows key by key: integers exact, floats within
    ``FLOAT_TOL`` (ownership may differ between the two clusters)."""
    assert set(want) == set(got), (sorted(set(want) ^ set(got))[:10])
    for k in want:
        w, g = want[k][1], got[k][1]
        assert set(w) == set(g)
        for name in w:
            if np.issubdtype(w[name].dtype, np.floating):
                np.testing.assert_allclose(g[name], w[name], rtol=FLOAT_TOL,
                                           atol=FLOAT_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(g[name], w[name],
                                              err_msg=f"{name} @ {k}")


def both(run, scenario, type_name="RouteCounter", compare=True):
    """Run ``scenario(side)`` (a coroutine function returning the cluster
    it drove, still running) on both sides; compare the rows (unless the
    scenario picks its keys by ownership, which differs between the
    sides); stop both.  Returns the two row dicts and the scenario's
    extra results."""
    out = {}
    for side in (J, P):
        async def main():
            cluster, extra = await scenario(side)
            try:
                return arena_rows(cluster, type_name), extra
            finally:
                await cluster.stop()
        out[side.name] = run(main())
    if compare:
        assert_same_rows(out["jax"][0], out["port"][0])
    return out["jax"], out["port"]


# -- ownership ---------------------------------------------------------------

def test_ring_hash_vectorized_matches_scalar_and_jax():
    rng = np.random.default_rng(7)
    keys = np.concatenate([rng.integers(0, 2**63, 500, dtype=np.int64),
                           np.arange(32)])
    for tc in (1, 77, 2**30 + 123):
        vec = ring_hash_int_keys(tc, keys)
        scalar = np.array([GrainId.from_int(tc, int(k)).ring_hash()
                           for k in keys], dtype=np.uint32)
        np.testing.assert_array_equal(vec, scalar)
        np.testing.assert_array_equal(vec, jax_ring_hash_int_keys(tc, keys))
    for a in (SiloAddress("h", 7, 3), SiloAddress("silo1", 0, 11)):
        assert a.ring_hash() == JaxSiloAddress(a.host, a.port,
                                               a.generation).ring_hash()


@pytest.mark.parametrize("members", [1, 2, 3])
def test_ring_owner_agrees_for_equal_silo_addresses(members):
    """Rings built from equal (host, port, generation) triples give every
    key of a sample the same owner in both packages."""
    triples = [("silo1", 0, 41), ("silo2", 0, 42), ("silo3", 7, 99)][:members]
    port_ring = VirtualBucketsRing(SiloAddress(*triples[0]))
    jax_ring = JaxRing(JaxSiloAddress(*triples[0]))
    for t in triples[1:]:
        port_ring.add_silo(SiloAddress(*t))
        jax_ring.add_silo(JaxSiloAddress(*t))
    tc = vector_type("RouteCounter").type_code
    keys = np.random.default_rng(3).integers(0, 2**62, 4000, dtype=np.int64)
    points = ring_hash_int_keys(tc, keys)
    own_p, mem_p = port_ring.owners_of_hashes(points)
    own_j, mem_j = jax_ring.owners_of_hashes(points)
    assert [str(m) for m in np.asarray(mem_p)[own_p]] \
        == [str(m) for m in np.asarray(mem_j)[own_j]]
    if members > 1:
        assert len(set(own_p.tolist())) == members
    for k in keys[:50].tolist():
        assert str(port_ring.calculate_target_silo(GrainId.from_int(tc, k))) \
            == str(jax_ring.calculate_target_silo(JaxGrainId.from_int(tc, k)))


# -- K22's plain version -----------------------------------------------------

def _random_tree(rng, n):
    return {
        "a": rng.random(n, dtype=np.float32),
        "b": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "c": (rng.random((n, 4), dtype=np.float32),
              rng.random(n) < 0.5),
        "f": 2.5,
        "s": np.int32(7),
    }  # keys in sorted order: JAX walks a dict's leaves by sorted key


@pytest.mark.parametrize("n,m,seed", [(1, 1, 0), (257, 100, 1),
                                      (1000, 1000, 2), (50, 0, 3)])
def test_gather_args_plain_equals_jax_gather_args_dev(n, m, seed):
    rng = np.random.default_rng(seed)
    tree = _random_tree(rng, n)
    idx = rng.integers(0, n, m).astype(np.int32)
    want = _gather_args_dev(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(idx))
    port_tree = krouter.tree_replace(tree, [
        torch.from_numpy(np.ascontiguousarray(x))
        for x in krouter.tree_leaves(tree) if not krouter.is_scalar_leaf(x)])
    _, _, _, (got,) = krouter.gather_tree(port_tree, torch.from_numpy(idx))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    krouter.tree_leaves(got)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got["s"] is port_tree["s"] and got["f"] == 2.5


def test_gather_args_split_segments_and_edges():
    """Segments of one permutation land in one packed, 16-byte aligned
    buffer; each equals the JAX gather of its own lanes.  int64 leaves
    (which JAX without x64 cannot hold) equal numpy's take; an all-scalar
    tree gathers nothing; one leaf; m = 0."""
    rng = np.random.default_rng(11)
    n = 333
    tree = _random_tree(rng, n)
    tree["w"] = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    perm = rng.permutation(n).astype(np.int32)
    bounds = [0, 100, 100, 250, n]
    leaves = krouter.payload_leaves(tree, torch.device("cpu"))
    staging, views, layout = krouter.gather_args(leaves, torch.from_numpy(perm),
                                                 bounds)
    assert all(off % 16 == 0 for row in layout.offs for off in row)
    assert layout.size == staging.numel()
    host = krouter.fetch_segments(
        staging, layout, leaves, krouter.tree_replace(tree, views[0]))
    for s in range(len(bounds) - 1):
        part = perm[bounds[s]:bounds[s + 1]]
        for leaf, v in zip(leaves, views[s]):
            np.testing.assert_array_equal(v.numpy(), leaf.numpy()[part])
        if s:
            for leaf, v in zip(leaves, krouter.tree_leaves(host[s - 1])):
                if not krouter.is_scalar_leaf(v):
                    np.testing.assert_array_equal(v, leaf.numpy()[part])
    np.testing.assert_array_equal(views[3][-1].numpy(), tree["w"][perm[250:]])
    # an all-scalar tree: nothing to gather, scalars pass through
    _, _, lv, (t,) = krouter.gather_tree({"x": 3, "y": np.float32(1)},
                                         torch.from_numpy(perm))
    assert lv == [] and t == {"x": 3, "y": np.float32(1)}
    # one leaf, m = 0
    one = torch.arange(10, dtype=torch.int32)
    _, views, _ = krouter.gather_args([one], torch.zeros(0, dtype=torch.int32))
    assert views[0][0].shape == (0,)
    with pytest.raises(TypeError):
        krouter.gather_args([one], torch.zeros(3, dtype=torch.int64))


def _block_lanes(launch, block):
    """(segment, first lane, end lane) of ``idx`` that ``block`` of a K22
    launch covers, as csrc/router.cu's kernel finds them."""
    s = 0
    while s + 1 < len(launch.lanes) and launch.block0[s + 1] <= block:
        s += 1
    lo = (block - launch.block0[s]) * krouter.LANES_PER_BLOCK
    hi = min(lo + krouter.LANES_PER_BLOCK, launch.lanes[s])
    return launch.segments[s], launch.lane0[s] + lo, launch.lane0[s] + hi


@pytest.mark.parametrize("counts,widths", [
    ([3 * 1024 + 5, 0, 1, 4097], [4, 1, 16]),
    ([7] * 20, [4, 8, 1, 2, 16, 12, 3, 4, 8, 4]),
    ([0, 0], [4]),
    ([524_291, 524_285], [4, 4, 4]),
])
def test_k22_block_plan_covers_every_lane_once(counts, widths):
    """K22's host-side block plan: in every launch each block covers a
    run of at most ``LANES_PER_BLOCK`` lanes of one segment, the blocks
    cover every lane of every non-empty segment once, each (segment,
    leaf) piece is planned once at its 16-byte aligned offset, and a
    gather emulated block by block through the plan equals the plain
    version's packed buffer."""
    rng = np.random.default_rng(len(counts))
    m = sum(counts)
    leaves = [torch.from_numpy(rng.integers(0, 255, (64, w), dtype=np.uint8))
              for w in widths]
    layout = krouter.split_layout(leaves, counts)
    plans = krouter.plan_gather(layout, range(len(leaves)))
    assert all(off % 16 == 0 for row in layout.offs for off in row)
    starts = np.concatenate([[0], np.cumsum(counts)])
    covered = np.zeros((len(counts), len(leaves)), np.int64)
    lanes_hit = np.zeros(m, np.int64)
    for launch in plans:
        assert len(launch.lanes) <= krouter.MAX_SEGMENTS
        assert len(launch.leaves) <= krouter.MAX_LEAVES
        for i, s in enumerate(launch.segments):
            assert launch.offs[i] == [layout.offs[s][j] for j in launch.leaves]
            covered[s, launch.leaves] += 1
        for b in range(launch.block0[-1]):
            s, lo, hi = _block_lanes(launch, b)
            assert starts[s] <= lo < hi <= starts[s + 1]
            assert hi - lo <= krouter.LANES_PER_BLOCK
            if launch.leaves[0] == 0:
                lanes_hit[lo:hi] += 1
    np.testing.assert_array_equal(lanes_hit, 1)
    np.testing.assert_array_equal(covered, np.broadcast_to(
        np.array(counts)[:, None] > 0, covered.shape))
    # the kernel's writes, emulated through the plan
    idx = rng.integers(-3, 70, m).astype(np.int32)
    want, _, _ = krouter.gather_args_plain(leaves, torch.from_numpy(idx),
                                           starts.tolist())
    got = np.zeros(layout.size, np.uint8)
    for launch in plans:
        for b in range(launch.block0[-1]):
            s, lo, hi = _block_lanes(launch, b)
            rows = np.clip(idx[lo:hi], 0, 63)
            for j in launch.leaves:
                off = layout.offs[s][j] + (lo - starts[s]) * widths[j]
                got[off:off + (hi - lo) * widths[j]] = \
                    leaves[j].numpy()[rows].reshape(-1)
    np.testing.assert_array_equal(got, want.numpy())


# -- the vector router twins -------------------------------------------------

def test_send_batch_partitions_across_silos(run):
    async def scenario(side):
        cluster = await side.cluster(3).start()
        a = cluster.silos[0]
        n = 600
        a.tensor_engine.send_batch("RouteCounter", "add",
                                   np.arange(n, dtype=np.int64),
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        rows = arena_rows(cluster, "RouteCounter")
        hosts = {s for s, _ in rows.values()}
        received = sum(s.vector_router.messages_received
                       for s in cluster.silos)
        return cluster, (len(hosts), a.vector_router.messages_shipped,
                         a.vector_router.slabs_shipped, received)

    (rows, (hj, sj, slj, rj)), (_, (hp, sp, slp, rp)) = both(run, scenario)
    assert set(rows) == set(range(600))
    assert all(int(r["count"]) == 1 for _, r in rows.values())
    for hosts, shipped, slabs, received in ((hj, sj, slj, rj),
                                            (hp, sp, slp, rp)):
        assert hosts >= 2 and 0 < shipped and slabs <= 4
        assert received == shipped


def test_device_key_misses_ship_to_owner(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 200
        a.tensor_engine.send_batch("RouteCounter", "add", side.keys_dev(n),
                                   {"v": side.vals(np.ones(n, np.float32))})
        await cluster.quiesce_engines()
        hosts = {s for s, _ in arena_rows(cluster, "RouteCounter").values()}
        return cluster, hosts == {s.name for s in cluster.silos}

    (rows, spread_j), (_, spread_p) = both(run, scenario)
    assert set(rows) == set(range(200)) and spread_j and spread_p
    assert all(int(r["count"]) == 1 for _, r in rows.values())


def test_cluster_injector_exact_counts(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 300
        inj = a.tensor_engine.make_injector("RouteCounter", "add",
                                            np.arange(n, dtype=np.int64))
        for t in range(3):
            inj.inject({"v": side.vals(np.full(n, t + 1, np.float32))})
        await cluster.quiesce_engines()
        return cluster, type(inj).__name__

    (rows, kind_j), (_, kind_p) = both(run, scenario)
    assert kind_j == kind_p == "ClusterInjector"
    assert all(int(r["count"]) == 3 and float(r["total"]) == 6.0
               for _, r in rows.values())


def test_device_key_want_results_routes_instead_of_activating(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 60
        res = await a.tensor_engine.send_batch(
            "RouteCounter", "add", side.keys_dev(n),
            {"v": np.arange(n, dtype=np.float32)}, want_results=True)
        await cluster.quiesce_engines()
        return cluster, np.asarray(res["echo"])

    (rows, ej), (_, ep) = both(run, scenario)
    np.testing.assert_array_equal(ep, ej)
    np.testing.assert_array_equal(ep, 2 * np.arange(60, dtype=np.float32))
    assert set(rows) == set(range(60))


def test_single_activation_under_concurrent_cross_silo_calls(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        futs = [s.tensor_engine.send_batch(
            "RouteCounter", "add", np.array([42], dtype=np.int64),
            {"v": np.array([1.0], np.float32)}, want_results=True)
            for _ in range(5) for s in cluster.silos]
        results = await asyncio.gather(*futs)
        await cluster.quiesce_engines()
        return cluster, [float(np.asarray(r["echo"])[0]) for r in results]

    (rows, ej), (_, ep) = both(run, scenario)
    assert list(rows) == [42] and int(rows[42][1]["count"]) == 10
    assert ej == ep == [2.0] * 10


@pytest.mark.parametrize("migrate", [True, False])
def test_join_evicts_strays_to_new_owner(run, migrate):
    """A join moves ring ranges: the old owner pushes its strays to the
    new owner (``handoff_migration``) under the store write-back, or only
    writes back and evicts; either way counters are conserved."""
    def tune(cfg):
        cfg.rebalance.handoff_migration = migrate

    async def scenario(side):
        cluster = await side.cluster(1, store=True, tune=tune).start()
        a = cluster.silos[0]
        n = 150
        keys = np.arange(n, dtype=np.int64)
        a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        await cluster.start_additional_silo()
        await cluster.wait_for_liveness_convergence()
        await asyncio.sleep(0.1)  # the handoff
        a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        rows = arena_rows(cluster, "RouteCounter")
        return cluster, (len({s for s, _ in rows.values()}),
                         a.vector_router.grains_migrated_out)

    (rows, (hj, mj)), (_, (hp, mp)) = both(run, scenario)
    assert hj == hp == 2
    assert (mj > 0) == (mp > 0) == migrate
    assert all(int(r["count"]) == 2 for _, r in rows.values())


def test_injector_repartitions_after_membership_change(run):
    async def scenario(side):
        cluster = await side.cluster(1, store=True).start()
        a = cluster.silos[0]
        n = 120
        inj = a.tensor_engine.make_injector("RouteCounter", "add",
                                            np.arange(n, dtype=np.int64))
        inj.inject({"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        await cluster.start_additional_silo()
        await cluster.wait_for_liveness_convergence()
        await asyncio.sleep(0.1)
        inj.inject({"v": side.vals(np.ones(n, np.float32))})
        await cluster.quiesce_engines()
        hosts = {s for s, _ in arena_rows(cluster, "RouteCounter").values()}
        return cluster, len(hosts)

    (rows, hj), (_, hp) = both(run, scenario)
    assert hj == hp == 2
    assert all(int(r["count"]) == 2 for _, r in rows.values())


def test_stale_enqueued_batch_reroutes_at_resolve_time(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 80
        # a batch that bypassed enqueue routing, as one proven local before
        # a ring move would have
        a.tensor_engine.enqueue_local_batch(
            "RouteCounter", "add", np.arange(n, dtype=np.int64),
            {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        hosts = {s for s, _ in arena_rows(cluster, "RouteCounter").values()}
        return cluster, len(hosts)

    (rows, hj), (_, hp) = both(run, scenario)
    assert hj == hp == 2 and set(rows) == set(range(80))
    assert all(int(r["count"]) == 1 for _, r in rows.values())


def test_fuse_ticks_rejects_remote_keys_and_call_slab_hop_bound(run):
    async def main():
        cluster = await _port_cluster(2).start()
        try:
            a, b = cluster.silos
            with pytest.raises(ValueError, match="ring-owned by other"):
                a.tensor_engine.fuse_ticks("RouteCounter", "add",
                                           np.arange(50, dtype=np.int64))
            tc = vector_type("RouteCounter").type_code
            key = next(k for k in range(100)
                       if b.ring.calculate_target_silo(
                           GrainId.from_int(tc, k)) != b.address)
            with pytest.raises(RuntimeError, match="forward count"):
                await b.vector_router.call_slab(
                    "RouteCounter", "add", np.array([key], dtype=np.int64),
                    {"v": np.array([1.0], np.float32)},
                    hops=b.max_forward_count + 1)
        finally:
            await cluster.stop()

    run(main())


# -- auto-fusion on a clustered silo ----------------------------------------

def _fusing(**cfg):
    """A silo setup that engages auto-fusion after 3 ticks, windows of 4."""
    def setup(silo):
        engine_cfg = silo.tensor_engine.config
        engine_cfg.auto_fusion_ticks = 3
        engine_cfg.auto_fusion_window = 4
        for k, v in cfg.items():
            setattr(engine_cfg, k, v)
    return setup


async def _hop_ticks(engine, inj, n, ticks, t0, dst_of):
    """tests/test_torch_fused.py's hop loop from tick ``t0``."""
    for t in range(t0, t0 + ticks):
        inj.inject({"dst": np.full(n, dst_of(t), np.int32),
                    "v": np.full(n, t + 1, np.int32)})
        await engine.drain_queues()
    await engine.flush()


def _owned(silo, type_name, lo, count):
    """The first ``count`` keys from ``lo`` that ``silo`` owns."""
    cand = np.arange(lo, lo + 8 * count, dtype=np.int64)
    local, _ = silo.vector_router.partition(type_name, cand)
    return cand[np.asarray(local)][:count]


def test_autofuse_ban_lifts_when_the_ring_changes(run):
    """A pattern banned by rollbacks on a clustered silo fuses again once
    the ring changes (a silo leaves): the ring version is part of the
    fuser's signature and of its ban.  Sources and destinations are keys
    that silo a owns, which differ between the sides, so each side's
    destination rows are checked against the same expectation."""
    n, W = 32, 4

    async def scenario(side):
        cluster = await side.cluster(
            2, store=True,
            setup=_fusing(auto_fusion_max_rollbacks=2)).start()
        a, b = cluster.silos
        engine = a.tensor_engine
        src, dst = _owned(a, "TwinHopGrain", 0, n), \
            _owned(a, "TwinLwwGrain", 1000, 8)
        inj = engine.make_injector("TwinHopGrain", "send", src)
        # a fresh cold destination every window: windows roll back
        await _hop_ticks(engine, inj, n, 32, 0, lambda t: dst[t // W])
        await cluster.quiesce_engines()
        af = engine.autofuser
        banned = (af.windows_rolled_back, bool(af._disabled))
        ran = af.windows_run
        await cluster.stop_silo(b)
        await cluster.wait_for_liveness_convergence()
        # one warm destination, the same injector: the pattern fuses again
        await _hop_ticks(engine, inj, n, 24, 32, lambda t: dst[0])
        await cluster.quiesce_engines()
        return cluster, (banned, af.windows_run - ran)

    (rows_j, (bj, fj)), (rows_p, (bp, fp)) = both(
        run, scenario, type_name="TwinLwwGrain", compare=False)
    assert bj == bp == (2, True)
    assert fj > 0 and fp > 0, (fj, fp)
    for rows in (rows_j, rows_p):  # each side's own destinations
        got = sorted((int(r["count"]), int(r["value"]))
                     for _, r in rows.values())
        assert got == sorted([(n * W, 4 * w + 4) for w in range(1, 8)]
                             + [(n * (W + 24), 56)])


def test_autofuse_never_fuses_a_source_with_remote_owned_keys(run):
    """A steady pattern whose key set is not all ring-owned here never
    fuses (tests/test_autofuse.py test_clustered_ban_for_remote_keys): an
    injector built directly, bypassing the ownership split, as a stale
    split would.  Delivery stays exact through the unfused path."""
    n, T = 64, 12

    async def scenario(side):
        cluster = await side.cluster(2, setup=_fusing()).start()
        a = cluster.silos[0]
        keys = np.arange(n, dtype=np.int64)
        _, remote = a.vector_router.partition("TwinLwwGrain", keys)
        assert remote, "expected a split key set"
        engine = a.tensor_engine
        inj = side.Injector(engine, "TwinLwwGrain", "put", keys)
        for t in range(T):
            inj.inject({"v": np.full(n, t + 1, np.int32)})
            await engine.drain_queues()
        await cluster.quiesce_engines()
        af = engine.autofuser
        return cluster, (af.windows_run, bool(af._disabled))

    (rows, fj), (_, fp) = both(run, scenario, type_name="TwinLwwGrain")
    assert fj == fp == (0, True)
    assert set(rows) == set(range(n))
    assert all(int(r["count"]) == T and int(r["value"]) == T
               for _, r in rows.values())


def test_dispatcher_forwards_vector_message_to_owner(run):
    """A vector grain's request entering a non-owner silo's message center
    forwards to the owner (reference: Dispatcher.TryForwardRequest :474);
    the response returns to the caller's callback."""
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a, b = cluster.silos
        tc = vector_type("RouteCounter").type_code
        key = next(k for k in range(100)
                   if a.ring.calculate_target_silo(
                       side.GrainId.from_int(tc, k)) == b.address)
        m = side.msg
        msg = m.Message(category=m.Category.APPLICATION,
                        direction=m.Direction.REQUEST,
                        sending_grain=a.client_grain_id,
                        target_grain=side.GrainId.from_int(tc, key),
                        method_name="add", args=({"v": 5.0},))
        fut = asyncio.get_running_loop().create_future()
        a.runtime_client.callbacks[msg.id] = side.Callback(future=fut,
                                                           message=msg)
        a.message_center.send_message(msg)
        res = await asyncio.wait_for(fut, 10)
        await cluster.quiesce_engines()
        owner = arena_rows(cluster, "RouteCounter")[key][0]
        return cluster, (float(np.asarray(res["echo"])), owner == b.name)

    (rows_j, rj), (rows_p, rp) = both(run, scenario, compare=False)
    assert rj == rp == (10.0, True)
    assert len(rows_j) == len(rows_p) == 1


def test_graceful_handoff_restores_state(run):
    async def scenario(side):
        cluster = await side.cluster(2, store=True).start()
        a, b = cluster.silos
        n = 200
        keys = np.arange(n, dtype=np.int64)
        a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        on_b = sum(1 for s, _ in arena_rows(cluster, "RouteCounter").values()
                   if s == b.name)
        await cluster.stop_silo(b)
        await cluster.wait_for_liveness_convergence()
        a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        return cluster, on_b

    (rows, bj), (_, bp) = both(run, scenario)
    assert bj > 0 and bp > 0
    assert all(int(r["count"]) == 2 for _, r in rows.values())


def _miss_tolerant(cfg):
    """Liveness that tolerates missed probes until ``_fast_again``.  The
    JAX silos compile their step, plan and checkpoint programs on the
    silos' shared event loop during the first ticks: stalls of 0.2 to
    1.8 s on the CPU, longer under load.  A stall longer than
    ``probe_timeout`` while a probe is out counts as a missed probe, so
    two of them made the healthy silos declare each other dead."""
    cfg.liveness.num_missed_probes_limit = 1_000_000


def _fast_again(cluster):
    """Back to ``_fast``'s limit of two missed probes (read live by the
    prober), so a kill from here on is detected at once."""
    for silo in cluster.silos:
        silo.config.liveness.num_missed_probes_limit = 2


def test_hard_kill_restores_from_periodic_checkpoint(run):
    def setup(silo):
        silo.tensor_engine.config.checkpoint_every_ticks = 1

    async def scenario(side):
        cluster = await side.cluster(2, store=True, tune=_miss_tolerant,
                                     setup=setup).start()
        a, b = cluster.silos
        n = 200
        keys = np.arange(n, dtype=np.int64)
        for _ in range(3):
            a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                       {"v": np.ones(n, np.float32)})
            await cluster.quiesce_engines()
        on_b = sum(1 for s, _ in arena_rows(cluster, "RouteCounter").values()
                   if s == b.name)
        _fast_again(cluster)
        cluster.kill_silo(b)
        await cluster.wait_for_liveness_convergence()
        a.tensor_engine.send_batch("RouteCounter", "add", keys,
                                   {"v": np.ones(n, np.float32)})
        await cluster.quiesce_engines()
        restored = a.tensor_engine.arenas["RouteCounter"].restored_count
        return cluster, (on_b, restored)

    (rows, (bj, rj)), (_, (bp, rpt)) = both(run, scenario)
    assert all(int(r["count"]) == 4 for _, r in rows.values())
    assert rj >= bj > 0 and rpt >= bp > 0


def test_fence_defers_batch_with_fanout_unexpanded(run):
    """A batch the handoff fence defers keeps its fan-out unexpanded: the
    source update and the subscriber delivery land in one later tick."""
    async def scenario(side):
        cluster = await side.cluster(1).start()
        silo = cluster.silos[0]
        engine = silo.tensor_engine
        fan = side.Fanout(budget=16)
        fan.follow(1, 2)
        engine.register_fanout("FenceGrain", "ping", fan, "FenceGrain",
                               "note")
        engine.send_batch("FenceGrain", "note", np.array([2], np.int64),
                          {"v": np.array([0], np.int32)})
        await engine.drain_queues()
        arena = engine.arena_for("FenceGrain")
        router = silo.vector_router
        orig = router.handoff_settled
        router.handoff_settled = lambda: False
        try:
            engine.send_batch("FenceGrain", "ping", np.array([1], np.int64),
                              {"v": np.array([7], np.int32)})
            for _ in range(3):
                engine.run_tick()
            held = (int(arena.read_row(2)["notes"]),
                    bool(arena.lookup_rows(np.array([1], np.int64))[1][0]))
        finally:
            router.handoff_settled = orig
        await engine.flush()
        return cluster, held

    (rows, hj), (_, hp) = both(run, scenario, "FenceGrain")
    assert hj == hp == (1, False)
    assert int(rows[1][1]["hits"]) == 1 and int(rows[2][1]["notes"]) == 2


@pytest.mark.parametrize("aggregate", [True, False])
def test_sender_aggregation_on_and_off(run, aggregate):
    def tune(cfg):
        cfg.tensor.slab_aggregation = aggregate

    async def scenario(side):
        cluster = await side.cluster(2, tune=tune).start()
        a = cluster.silos[0]
        n, parts = 400, 8
        keys = np.arange(n, dtype=np.int64)
        for i in range(parts):
            lo, hi = i * n // parts, (i + 1) * n // parts
            a.tensor_engine.send_batch("RouteCounter", "add", keys[lo:hi],
                                       {"v": np.ones(hi - lo, np.float32)})
        await cluster.quiesce_engines()
        snap = a.vector_router.snapshot()
        return cluster, (snap["slab_fragments"], snap["slab_frames"],
                         snap["slab_merge_ratio"])

    (rows, sj), (_, sp) = both(run, scenario)
    assert sj == sp
    assert all(int(r["count"]) == 1 for _, r in rows.values())
    if aggregate:
        assert sp[0] > sp[1] and sp[1] <= 1 and sp[2] > 1.0
    else:
        assert sp[0] == sp[1] and sp[2] == 1.0


def test_merged_fragments_preserve_scalar_leaf_broadcast(run):
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 200
        keys = np.arange(n, dtype=np.int64)
        a.tensor_engine.send_batch("RouteCounter", "add", keys[:n // 2],
                                   {"v": np.float32(1.0)})
        a.tensor_engine.send_batch("RouteCounter", "add", keys[n // 2:],
                                   {"v": np.float32(3.0)})
        await cluster.quiesce_engines()
        return cluster, None

    (rows, _), _ = both(run, scenario)
    for k, (_, r) in rows.items():
        assert float(r["total"]) == (1.0 if k < 100 else 3.0)


# -- tensors rewritten in place ----------------------------------------------

def test_staged_payload_rewritten_in_place_delivers_stage_time_values(run):
    """``ClusterInjector.stage`` keeps a copy: rewriting the staged tensor
    before ``inject()`` does not change what is delivered (a JAX array
    cannot change, so JAX delivers the staged values)."""
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 100
        inj = a.tensor_engine.make_injector("RouteCounter", "add",
                                            np.arange(n, dtype=np.int64))
        v = side.vals(np.arange(n, dtype=np.float32))
        inj.stage({"v": v})
        if side is P:
            v.fill_(-1.0)
        inj.inject()
        await cluster.quiesce_engines()
        return cluster, None

    (rows, _), _ = both(run, scenario)
    assert all(float(r["total"]) == k for k, (_, r) in rows.items())


def test_shipped_payload_rewritten_before_the_peers_tick(run):
    """A device payload split by K22: the remote slices cross to the host
    at inject, so rewriting the caller's tensor before the peer's tick
    (and before the slab frame flushes) changes nothing delivered."""
    async def scenario(side):
        cluster = await side.cluster(2).start()
        a = cluster.silos[0]
        n = 100
        inj = a.tensor_engine.make_injector("RouteCounter", "add",
                                            np.arange(n, dtype=np.int64))
        v = side.vals(np.arange(n, dtype=np.float32))
        inj.inject({"v": v})
        if side is P:
            v.fill_(-1.0)  # before the flush and every tick
        await cluster.quiesce_engines()
        return cluster, a.vector_router.messages_shipped

    (rows, sj), (_, sp) = both(run, scenario)
    assert sj > 0 and sp > 0
    assert all(float(r["total"]) == k for k, (_, r) in rows.items())


# -- cross-silo Presence -----------------------------------------------------

def test_cross_silo_presence_exact_and_receiver_caches_injectors(run):
    """Presence over 2 silos, device payloads: heartbeats split by K22's
    plain version, remote games miss and ship; every heartbeat reaches its
    game once; player and game rows equal the JAX cluster's key by key;
    the receiver caches a BatchInjector per recurring slab shape."""
    out = {}
    for side in (J, P):
        async def main():
            cluster = await side.cluster(2).start()
            try:
                a, b = cluster.silos
                await side.presence(a.tensor_engine, n_players=N_PLAYERS,
                                    n_games=N_GAMES, n_ticks=N_TICKS)
                await cluster.quiesce_engines()
                shipped = sum(s.vector_router.messages_shipped
                              for s in cluster.silos)
                received = sum(s.vector_router.messages_received
                               for s in cluster.silos)
                cached = [inj.rows is not None for inj in
                          b.vector_router._slab_injectors.values()]
                split = all(s.tensor_engine.arenas["PresenceGrain"].live_count
                            for s in cluster.silos)
                return (arena_rows(cluster, "PresenceGrain"),
                        arena_rows(cluster, "GameGrain"),
                        (shipped, received, cached, split))
            finally:
                await cluster.stop()
        out[side.name] = run(main())
    assert_same_rows(out["jax"][0], out["port"][0])
    assert_same_rows(out["jax"][1], out["port"][1])
    games = out["port"][1]
    assert sum(int(r["updates"]) for _, r in games.values()) \
        == N_PLAYERS * N_TICKS
    shipped, received, cached, split = out["port"][2]
    assert shipped > N_PLAYERS and received == shipped and split
    assert cached and all(cached)


def test_k22_launches_nothing_on_the_cpu_and_one_split_per_inject(run):
    """On the CPU the cluster injector takes K22's plain version (no
    launch is counted); its split is one permutation of the key set."""
    async def main():
        cluster = await _port_cluster(2).start()
        try:
            a = cluster.silos[0]
            n = 64
            inj = a.tensor_engine.make_injector("RouteCounter", "add",
                                                np.arange(n, dtype=np.int64))
            assert isinstance(inj, ClusterInjector)
            assert sorted(inj._perm.tolist()) == list(range(n))
            assert inj._bounds[0] == 0 and inj._bounds[-1] == n
            before = krouter.gather_args.launches
            inj.inject({"v": torch.ones(n)})
            await cluster.quiesce_engines()
            assert krouter.gather_args.launches == before
        finally:
            await cluster.stop()

    run(main())


def test_engine_less_silo_releases_fences_with_the_stub(run):
    """A clustered silo without a tensor engine registers
    ``HandoffFenceStub``: it releases its peers' handoff fences at once
    (it owns no rows), so a ring change settles without the fence
    timeout."""
    from orleans_tpu_torch.tensor.router import HandoffFenceStub

    def tune(cfg):
        if cfg.name == "silo2":
            cfg.tensor.enabled = False

    async def main():
        cluster = await _port_cluster(1, tune=tune).start()
        try:
            a = cluster.silos[0]
            a.vector_router.handoff_timeout = 30.0
            b = await cluster.start_additional_silo()
            await cluster.wait_for_liveness_convergence()
            assert b.tensor_engine is None and b.vector_router is None
            assert isinstance(b.system_targets["vector_router"],
                              HandoffFenceStub)
            for _ in range(200):
                if a.vector_router.handoff_settled():
                    break
                await asyncio.sleep(0.005)
            assert a.vector_router.handoff_settled()
        finally:
            await cluster.stop()

    run(main())


def test_codec_writes_the_jax_token_stream_and_splits_slab_trees():
    """The port's codec writes the JAX package's bytes for identities,
    arrays and containers, and reads them back; a slab tree splits into
    the skeleton and arrays JAX's ``flatten_slab_tree`` gives."""
    from orleans_tpu.codec import default_manager as jax_codec
    from orleans_tpu.codec import flatten_slab_tree as jax_flatten

    from orleans_tpu_torch.codec import (
        SlabLeafRef,
        default_manager,
        flatten_slab_tree,
        unflatten_slab_tree,
    )

    def value(G, S):
        return {"k": np.arange(5, dtype=np.int64), "g": G.from_int(3, 7),
                "s": S("h", 1, 2), "l": [1, -2**40, 2.5, "x", None, True],
                "t": (b"ab", np.ones((2, 3), np.float32))}

    port_bytes = default_manager.serialize(value(GrainId, SiloAddress))
    assert port_bytes == jax_codec.serialize(value(JaxGrainId,
                                                   JaxSiloAddress))
    back = default_manager.deserialize(port_bytes)
    assert back["g"] == GrainId.from_int(3, 7) and back["s"].generation == 2
    np.testing.assert_array_equal(back["t"][1], np.ones((2, 3), np.float32))
    tree = {"a": np.arange(4), "b": (np.float32(2), 3), "c": torch.ones(2)}
    skel, arrays = flatten_slab_tree(tree)
    jskel, jarrays = jax_flatten({**tree, "c": np.ones(2, np.float32)})
    assert [a.tolist() for a in arrays] == [a.tolist() for a in jarrays]
    assert skel["b"][1] == jskel["b"][1] == 3
    assert isinstance(skel["c"], SlabLeafRef) and skel["c"].index == 2
    again = unflatten_slab_tree(skel, arrays)
    np.testing.assert_array_equal(again["c"], np.ones(2, np.float32))


def test_without_wire_fidelity_a_message_carries_a_copy_of_its_tensor(run):
    """Without wire fidelity the JAX fabric hands the peer the message
    object itself; the port hands it a deep copy of the arguments, so a
    tensor its sender rewrites after the send arrives as it was sent."""
    async def main():
        cluster = TestingCluster(n_silos=2, device="cpu", wire_fidelity=False,
                                 config_factory=lambda n: _fast(
                                     SiloConfig(name=n)))
        await cluster.start()
        try:
            a, b = cluster.silos
            tc = vector_type("RouteCounter").type_code
            key = next(k for k in range(100)
                       if a.ring.calculate_target_silo(
                           GrainId.from_int(tc, k)) == b.address)
            m = port_messaging
            v = torch.tensor(4.0)
            msg = m.Message(category=m.Category.APPLICATION,
                            direction=m.Direction.REQUEST,
                            sending_grain=a.client_grain_id,
                            target_silo=b.address,
                            target_grain=GrainId.from_int(tc, key),
                            method_name="add", args=({"v": v},))
            fut = asyncio.get_running_loop().create_future()
            a.runtime_client.callbacks[msg.id] = CallbackData(
                future=fut, message=msg)
            a.message_center.send_message(msg)
            v.fill_(-1.0)  # before the peer reads it
            res = await asyncio.wait_for(fut, 10)
            assert float(np.asarray(res["echo"])) == 8.0
        finally:
            await cluster.stop()

    run(main())


def test_placement_overrides_beat_the_ring_hash(run):
    """Placement overrides (live migration's exception table, and every
    key a handoff adopted) rewrite the hash owner in one vectorized pass:
    each key's owner is its override where it has one, else its ring
    owner — including a target outside the ring."""
    async def main():
        cluster = await _port_cluster(2).start()
        try:
            a, b = cluster.silos
            router = a.vector_router
            ghost = SiloAddress("ghost", 0, 10**9)
            keys = np.arange(5000, dtype=np.int64)
            rng = np.random.default_rng(5)
            pins = {int(k): t for k, t in zip(
                rng.choice(keys, 900, replace=False),
                [a.address, b.address, ghost] * 300)}
            for t in (a.address, b.address, ghost):
                router.register_placement(
                    "RouteCounter", np.array([k for k, v in pins.items()
                                              if v == t]), t)
            local, remote = router.partition("RouteCounter", keys)
            owner = {int(k): a.address for k in keys[local]}
            for t, idx in remote.items():
                owner.update({int(k): t for k in keys[idx]})
            tc = vector_type("RouteCounter").type_code
            for k in keys.tolist():
                want = pins.get(k) or a.ring.calculate_target_silo(
                    GrainId.from_int(tc, k))
                assert owner[k] == want, k
            assert ghost in remote
        finally:
            await cluster.stop()

    run(main())
