"""K24 ``exchange_buckets`` and K5 ``hist_count`` on the CPU: what the
CUDA kernels compute is emulated in numpy, step by step as the kernels
take it, and held against the plain versions and the JAX functions.

* K24's phase 1: per (chunk, tile of 1024 lanes) the histogram of the
  cross lanes' destinations and the valid count, 4 consecutive lanes a
  thread, lanes past L or m invalid; at n <= 8 a warp's counts packed in 8
  fields of 8 bits (no field may carry).
* Phase 2: the exclusive scan over the tiles of each (chunk, bin) and its
  total; need, ``before`` and the stats derived from the totals alone, as
  every later block derives them.
* Phase 3: each warp's 128 lanes in 4 rounds of 32 (4 a thread strided
  by 32), a lane's rank the warp's running count of its destination plus
  the lower lanes of its round that share it, a prefix over the 8 warps;
  the tile's cross lanes ordered by destination (each destination's run,
  the part of it that fits, its first slot), written a run at a time;
  the dropped lanes; the fill ranges (legacy one per (source,
  destination), per-destination one per receiver) in 16-byte stores
  framed by byte heads and tails — together they write every output
  lane exactly once.
* K5: 16-lane groups after a scalar head up to the mask's 16-byte
  boundary, a scalar tail, rows read 16 bytes at a time or word by word;
  ``count_plan``'s split of one launch's blocks over up to 8 counts.
* The legacy and per-destination exchange through the port's dispatch
  with K24 replaced by the emulation, against the JAX ``ShardExchange``
  (as tests/test_torch_exchange.py's ``test_dispatch_equals_jax``); K5's
  emulation against JAX ``_count_rows_kernel``; a fused window whose
  counts wait for the tick's end, against the JAX window.

Every value compared is an integer: the comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orleans_tpu.config import MetricsConfig as JaxMetricsConfig
from orleans_tpu.config import TensorEngineConfig as JaxEngineConfig
from orleans_tpu.tensor import TensorEngine as JaxTensorEngine
from orleans_tpu.tensor.ledger import _count_rows_kernel
from orleans_tpu_torch.config import MetricsConfig, TensorEngineConfig
from orleans_tpu_torch.kernels import exchange as kx
from orleans_tpu_torch.kernels import hist
from orleans_tpu_torch.tensor import TensorEngine
from orleans_tpu_torch.tensor import exchange as port_exchange
from orleans_tpu_torch.tensor import fused as port_fused
from orleans_tpu_torch.tensor.mesh import ShardMesh

TILE, THREADS, WARPS = 1024, 256, 8
SITE = ("RouteSink", "recv")


# -- K24, emulated ------------------------------------------------------------

def lane_dest(rows, mask, sc, L, n, tiles):
    """Phase 1's loads: the destination of every lane of every chunk's
    tiles (n: invalid), 4 consecutive lanes a thread, the row's block by
    the host's multiplier; lanes past L or m read as invalid."""
    m = rows.shape[0]
    mul, shift = div_magic(sc)
    dest = np.full((n, tiles * TILE), n, np.int64)
    for s in range(n):
        for t in range(tiles):
            for th in range(THREADS):
                j0 = t * TILE + 4 * th
                i0 = s * L + j0
                lim = min(L - j0, m - i0)
                for k in range(min(4, max(lim, 0))):
                    r = int(rows[i0 + k])
                    if mask[i0 + k] and r >= 0:
                        dest[s, j0 + k] = min((r * mul) >> shift, n)
    return dest


def phase1(dest, n):
    """hist[s, t, b]: cross lanes bound for b < n, valid lanes in bin n;
    at n <= 8 each warp's counts as the kernel packs them."""
    tiles = dest.shape[1] // TILE
    hist_ = np.zeros((n, tiles, n + 1), np.int64)
    for s in range(n):
        tile = dest[s].reshape(tiles, WARPS, 32, 4)  # thread's 4 lanes
        valid = tile < n
        cross = valid & (tile != s)
        hist_[s, :, n] = valid.sum(axis=(1, 2, 3))
        for b in range(n):
            per_warp = (cross & (tile == b)).sum(axis=(2, 3))
            if n <= 8:
                # 8-bit fields: a thread adds at most 4, a warp 128
                per_thread = (cross & (tile == b)).sum(axis=3)
                assert per_thread.max(initial=0) <= 4
                assert per_warp.max(initial=0) <= 128 < 256
            hist_[s, :, b] = per_warp.sum(axis=1)
    return hist_


def phase2(hist_):
    """Each (chunk, bin) block: the exclusive scan over the tiles and its
    total."""
    off = np.cumsum(hist_, axis=1) - hist_
    return off, hist_.sum(axis=1)


def before_of(totals, n, s, d, cd):
    return int(sum(min(int(totals[q, d]), cd) for q in range(s)))


def tile_ranks(codes, n):
    """Phase 3's ranks of one tile: warp w's lanes [128 w, 128 w + 128) in
    4 rounds of 32; a lane's rank is its warp's running count of its
    destination plus the lower lanes of its round bound there; then each
    warp's offset, the exclusive prefix over the warps."""
    rank = np.zeros(TILE, np.int64)
    wc = np.zeros((WARPS, n), np.int64)
    for w in range(WARPS):
        run = np.zeros(n, np.int64)
        for k in range(4):
            jj = w * 128 + k * 32 + np.arange(32)
            c = codes[jj]
            for lane in range(32):
                if c[lane] < n:
                    lower = c[:lane] == c[lane]
                    rank[jj[lane]] = run[c[lane]] + lower.sum()
            for d in range(n):
                run[d] += (c == d).sum()
        wc[w] = run
    prefix = np.cumsum(wc, axis=0) - wc
    return rank, prefix


def fill_ranges(totals, n, L, W, cap=None, caps=None, R=None):
    """The fill blocks' ranges of empty bucket lanes, as (d, lo, hi)."""
    if caps is None:
        return [(d, L + s * cap + min(int(totals[s, d]), cap),
                 L + (s + 1) * cap) for s in range(n) for d in range(n)]
    out = []
    for d in range(n):
        inbound = before_of(totals, n, n, d, caps[d])
        out.append((d, L + min(inbound, R), W))
    return out


def stats_of(totals, n, cap=None, caps=None, R=None):
    """Block 0's stats from the totals."""
    cross = dropped = 0
    mx, sm = [], []
    for d in range(n):
        cd = cap if caps is None else caps[d]
        col = [int(totals[s, d]) for s in range(n)]
        fill = sum(min(v, cd) for v in col)
        drop = sum(col) - fill
        if caps is not None and fill > R:
            drop += fill - R
        cross += sum(col)
        dropped += drop
        mx.append(max(col))
        sm.append(sum(col))
    valid = int(totals[:, n].sum())
    return np.array([cross, dropped, valid - dropped] + mx + sm, np.int32)


def tile_runs(codes, rank, prefix, start, s, n, L, W, totals, cap=None,
              caps=None, R=None):
    """Phase 3's staging of one tile: per destination its run of cross
    lanes (``at``, the exclusive prefix of the runs' lengths), how many of
    the run fit (``keep``: the first ones, ranks being dense) and the slot
    of its first lane; ``order``, the tile's cross lanes by destination,
    stable.  Returns (order, at, keep, slot0, in-run index of each lane)."""
    lengths = np.array([(codes == d).sum() for d in range(n)], np.int64)
    at = np.concatenate([[0], np.cumsum(lengths)])
    keep, slot0 = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for d in range(n):
        st = int(start[d])
        if caps is None:
            room, first = cap - st, d * W + L + s * cap + st
        else:
            before = before_of(totals, n, s, d, caps[d])
            room = min(caps[d] - st, R - before - st)
            first = d * W + L + before + st
        keep[d] = min(max(room, 0), lengths[d])
        slot0[d] = first
    order = np.full(TILE, -1, np.int64)
    q = np.full(TILE, -1, np.int64)
    for jj in range(TILE):
        c = codes[jj]
        if c < n:
            q[jj] = prefix[jj // 128, c] + rank[jj]
            assert order[at[c] + q[jj]] == -1
            order[at[c] + q[jj]] = jj
    assert (order[:at[n]] >= 0).all()
    return order, at, keep, slot0, q


def emulate_k24(rows, mask, leaves, sc, L, n, cap=None, caps=None, R=None):
    """K24's three launches in numpy; every output lane starts as a marker
    and must be written exactly once."""
    m = rows.shape[0]
    tiles = -(-L // TILE)
    W = L + (n * cap if caps is None else R)
    dest = lane_dest(rows, mask, sc, L, n, tiles)
    off, totals = phase2(phase1(dest, n))
    writes = np.zeros(n * W, np.int64)
    out_rows = np.full(n * W, 0x5a5a5a5a, np.int32)
    out_mask = np.full(n * W, 7, np.uint8)
    out_leaves = [np.full((n * W, *x.shape[1:]), 99, x.dtype) for x in leaves]
    dropped = np.full(m, 7, np.uint8)

    def put(o, i, r, mk):
        out_rows[o] = r
        out_mask[o] = mk
        writes[o] += 1
        for x, out in zip(leaves, out_leaves):
            out[o] = x[i] if i < m else 0

    for s in range(n):
        for t in range(tiles):
            j = t * TILE + np.arange(TILE)
            d = dest[s, j]
            local = d == s
            codes = np.where((d < n) & ~local, d, n)
            rank, prefix = tile_ranks(codes, n)
            order, at, keep, slot0, q = tile_runs(
                codes, rank, prefix, off[s, t], s, n, L, W, totals, cap,
                caps, R)
            # (a) the own region
            for lane in np.flatnonzero(j < L):
                i = s * L + j[lane]
                r = int(rows[i]) if i < m else -1
                put(s * W + j[lane], i, r if local[lane] else -1,
                    local[lane])
            # (c) the bucket writes, a run's lanes on consecutive slots
            for x in range(at[n]):
                c = int(np.searchsorted(at, x, side="right") - 1)
                if x - at[c] < keep[c]:
                    i = s * L + t * TILE + order[x]
                    put(slot0[c] + x - at[c], i, int(rows[i]), 1)
            # (d) dropped
            for lane in np.flatnonzero(j < L):
                i = s * L + j[lane]
                if i < m:
                    dropped[i] = codes[lane] < n and q[lane] >= keep[codes[
                        lane]]
    for d, lo, hi in fill_ranges(totals, n, L, W, cap, caps, R):
        if hi > lo:
            sl = slice(d * W + lo, d * W + hi)
            out_rows[sl] = -1
            out_mask[sl] = 0
            writes[sl] += 1
            for o in out_leaves:
                o[sl] = 0
    assert (writes == 1).all(), "an output lane written twice or never"
    assert set(np.unique(dropped)) <= {0, 1}
    return (out_rows, out_leaves, out_mask.astype(bool), dropped.astype(bool),
            stats_of(totals, n, cap, caps, R))


def _plain(rows, mask, leaves, sc, L, n, **plan):
    out = kx.exchange_buckets_plain(
        torch.from_numpy(rows), torch.from_numpy(mask),
        [torch.from_numpy(x) for x in leaves], sc, L, n, **plan)
    return (out[0].numpy(), [x.numpy() for x in out[1]], out[2].numpy(),
            out[3].numpy(), out[4].numpy())


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)


def _lanes(rng, m, n, sc, L, ratio, hot=None):
    chunk = np.minimum(np.arange(m) // L, n - 1)
    other = (chunk + rng.integers(1, max(n, 2), m)) % n
    dest = np.where(rng.random(m) < ratio, other, chunk)
    if hot is not None:
        dest[:] = hot
    rows = (dest * sc + rng.integers(0, sc, m)).astype(np.int32)
    rows[rng.random(m) < 0.04] = -1
    rows[rng.random(m) < 0.01] = n * sc + 5  # past the arena: invalid
    return rows, rng.random(m) >= 0.03


# (name, n, m, L, plan or "cap"/"perdest" rule, hot destination)
K24_CASES = [
    ("legacy n8", 8, 8000, 1024, dict(cap=300), None),
    ("legacy n8 overflow", 8, 8000, 1024, dict(cap=40), None),
    ("perdest n8", 8, 8000, 1024,
     dict(caps=[300, 20, 300, 5, 300, 300, 0, 300], R=1024), None),
    ("perdest n8 receive overflow", 8, 8000, 1024,
     dict(caps=[300] * 8, R=200), None),
    ("n1", 1, 1500, 1500, dict(cap=1), None),
    ("n2 L off the tile", 2, 2900, 1500, dict(cap=700), None),
    ("n12 ragged (match path)", 12, 2000, 200, dict(cap=30), None),
    ("one hot destination", 4, 4000, 1024, dict(cap=900), 3),
    ("everything dropped", 4, 4000, 1024, dict(caps=[0] * 4, R=4), None),
    ("cap 1", 8, 3001, 400, dict(cap=1), None),
]


@pytest.mark.parametrize("name,n,m,L,plan,hot", K24_CASES,
                         ids=[c[0] for c in K24_CASES])
def test_k24_emulation_equals_plain(name, n, m, L, plan, hot):
    rng = np.random.default_rng(len(name) * 31 + n)
    sc = 50
    rows, mask = _lanes(rng, m, n, sc, L, 0.5, hot)
    leaves = [rng.integers(-9, 9, m).astype(np.float32),
              rng.integers(-2**40, 2**40, m, dtype=np.int64),
              rng.integers(0, 255, (m, 3)).astype(np.uint8),
              rng.integers(0, 9, (m, 2, 2)).astype(np.int32)]
    got = emulate_k24(rows, mask, leaves, sc, L, n, **plan)
    want = _plain(rows, mask, leaves, sc, L, n, **plan)
    _assert_same(got, want)
    if name == "everything dropped":
        assert int(want[4][1]) == int(want[4][0]) > 0
    if "overflow" in name or name == "cap 1":
        assert int(want[4][1]) > 0


def test_k24_scratch_and_fill_ranges_cover_the_buckets():
    """The fill ranges and the bucket writes partition every receiver's
    bucket region at the smoke's shape rule (ranges only: 8 blocks, the
    legacy grant and the per-destination receive rung)."""
    n, L, cap = 8, 524288, 65536
    rng = np.random.default_rng(4)
    totals = np.zeros((n, n + 1), np.int64)
    totals[:, :n] = rng.integers(0, 2 * cap, (n, n))
    np.fill_diagonal(totals[:, :n], 0)
    W = L + n * cap
    cover = np.zeros(n * W, np.int8)
    for d, lo, hi in fill_ranges(totals, n, L, W, cap=cap):
        cover[d * W + lo:d * W + hi] += 1
    for s in range(n):
        for d in range(n):
            f = min(int(totals[s, d]), cap)
            cover[d * W + L + s * cap:d * W + L + s * cap + f] += 1
    region = np.concatenate([np.arange(d * W + L, (d + 1) * W)
                             for d in range(n)])
    assert (cover[region] == 1).all()
    assert kx.MAX_SHARDS == 64


def div_magic(sc):
    """The host's multiplier and shift for a row's block, as
    ``exchange_buckets`` computes them: l = ceil(log2 sc), shift 31 + l,
    m = floor(2**shift / sc) + 1 (Granlund and Montgomery, N = 31)."""
    l = 0
    while (1 << l) < sc:
        l += 1
    return ((1 << (31 + l)) // sc) + 1, 31 + l


@pytest.mark.parametrize("sc", [1, 2, 3, 7, 50, 97, 131_072, 2**20 + 1,
                                2**30, 2**31 - 1, 1_000_003])
def test_k24_row_division_is_exact(sc):
    """A lane's block is (row * m) >> shift in 64 bits: exact for every
    row below 2**31, the product below 2**64."""
    m, shift = div_magic(sc)
    rng = np.random.default_rng(sc % 1000)
    rows = [0, 1, sc - 1, sc, sc + 1, 2**31 - 1, 2**31 - 2,
            (2**31 - 1) // sc * sc, (2**31 - 1) // sc * sc - 1]
    rows += [int(r) for r in rng.integers(0, 2**31, 2000)]
    for r in rows:
        if 0 <= r < 2**31:
            assert r * m < 2**64
            assert (r * m) >> shift == r // sc, r


def fill_partition(addr, b0, b1):
    """fill_bytes's split of bytes [b0, b1) at address ``addr``: byte
    head, 16-byte units, byte tail (as absolute byte offsets)."""
    p0, p1 = addr + b0, addr + b1
    u0, u1 = -(-p0 // 16) * 16, p1 // 16 * 16
    if u0 >= u1:
        return list(range(p0, p1)), [], []
    return (list(range(p0, u0)), list(range(u0, u1, 16)),
            list(range(u1, p1)))


@pytest.mark.parametrize("addr", [0, 4, 1, 13])
def test_fill_bytes_covers_each_byte_once(addr):
    rng = np.random.default_rng(addr)
    for _ in range(200):
        b0 = int(rng.integers(0, 300))
        b1 = b0 + int(rng.integers(0, 300))
        head, units, tail = fill_partition(addr, b0, b1)
        assert len(head) < 16 + 16 and len(tail) < 16
        got = sorted(head + [u + k for u in units for k in range(16)]
                     + tail)
        assert got == list(range(addr + b0, addr + b1))


# -- K24 through the dispatch, against JAX ------------------------------------

def _jax_engine(**cfg):
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("grains",))
    return JaxTensorEngine(
        mesh=mesh, initial_capacity=1024,
        config=JaxEngineConfig(auto_fusion_ticks=0,
                               exchange_structured="always", **cfg),
        metrics=JaxMetricsConfig(attribution_enabled=False))


def _port_engine(**cfg):
    return TensorEngine(
        mesh=ShardMesh(8, "cpu"), device="cpu", initial_capacity=1024,
        config=TensorEngineConfig(auto_fusion_ticks=0,
                                  exchange_structured="always", **cfg),
        metrics=MetricsConfig(attribution_enabled=False))


def _emulated(rows, mask, leaves, sc, L, n, cap=None, caps=None, R=None):
    out = emulate_k24(rows.numpy(), mask.numpy(),
                      [x.numpy() for x in leaves], sc, L, n, cap=cap,
                      caps=caps, R=R)
    return (torch.from_numpy(out[0]), [torch.from_numpy(x) for x in out[1]],
            torch.from_numpy(out[2]), torch.from_numpy(out[3]),
            torch.from_numpy(out[4]))


@pytest.mark.parametrize("per_dest,need,inbound", [
    ("never", [6] * 8, None),
    ("always", [8, 3, 12, 8, 1, 8, 20, 8], [10] * 8)],
    ids=["legacy", "perdest"])
def test_k24_emulation_through_dispatch_equals_jax(monkeypatch, per_dest,
                                                   need, inbound):
    import samples.routing  # noqa: F401 — registers the JAX sink type
    from orleans_tpu_torch.samples import routing  # noqa: F401

    calls = []

    def emulated(*a, **kw):
        calls.append(kw)
        return _emulated(*a, **kw)

    monkeypatch.setattr(port_exchange, "exchange_buckets", emulated)
    rng = np.random.default_rng(11)
    m = 1000
    rows = rng.integers(0, 1024, m).astype(np.int32)
    rows[rng.random(m) < 0.05] = -1
    mask = rng.random(m) < 0.93
    v = rng.integers(1, 9, m).astype(np.float32)
    c = rng.integers(-2**30, 2**30, m).astype(np.int32)
    je, pe = _jax_engine(exchange_per_dest=per_dest), \
        _port_engine(exchange_per_dest=per_dest)
    ja, pa = je.arena_for("RouteSink"), pe.arena_for("RouteSink")
    for e in (je, pe):
        e.exchange.observe_need(SITE, np.asarray(need),
                                None if inbound is None
                                else np.asarray(inbound))
    jout = je.exchange.dispatch(ja, jnp.asarray(rows),
                                {"v": jnp.asarray(v), "c": jnp.asarray(c)},
                                jnp.asarray(mask), site=SITE)
    pout = pe.exchange.dispatch(pa, torch.from_numpy(rows),
                                {"v": torch.from_numpy(v),
                                 "c": torch.from_numpy(c)},
                                torch.from_numpy(mask), site=SITE)
    assert len(calls) == 1 and ("caps" in calls[0]) == (per_dest == "always")
    (jr, ja2, jm, jd, js), (pr, pa2, pm, pd, ps) = jout, pout
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for k in ("v", "c"):
        np.testing.assert_array_equal(pa2[k].numpy(), np.asarray(ja2[k]))
    assert int(np.asarray(js)[1]) > 0  # both cases overflow


# -- K5, emulated -------------------------------------------------------------

def emulate_count(base, rows, offset, blocks):
    """One count as ``blocks`` blocks of 256 threads take it, the mask at
    byte ``offset`` of a 16-byte line: a scalar head up to the mask's
    16-byte boundary, 16-lane groups strided over the threads, a scalar
    tail; every lane read once."""
    m = base.shape[0]
    seen = np.zeros(m, np.int64)
    head = min((16 - offset % 16) % 16, m)
    groups = (m - head) // 16
    tail0 = head + 16 * groups
    G = blocks * THREADS
    acc = 0

    def hit(i):
        seen[i] += 1
        return int(base[i] and (rows is None or rows[i] >= 0))

    for g in range(min(G, 16)):
        if g < head:
            acc += hit(g)
        if g < m - tail0:
            acc += hit(tail0 + g)
    for g in range(G):
        for q in range(g, groups, G):
            for k in range(16):
                acc += hit(head + 16 * q + k)
    assert (seen == 1).all()
    return acc


@pytest.mark.parametrize("m", [0, 1, 15, 16, 17, 1000, 4099])
@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_k5_emulation_equals_plain_and_jax(m, offset):
    rng = np.random.default_rng(m * 16 + offset)
    base = rng.random(m) < 0.6
    rows = np.where(rng.random(m) < 0.3, -1, rng.integers(0, 50, m)) \
        .astype(np.int32)
    blocks = hist.count_plan([m], wave=3)[0]
    assert blocks == (0 if m == 0 else min(3, -(-m // (16 * THREADS))))
    for r in (rows, None):
        got = emulate_count(base, r, offset, max(blocks, 1))
        h = torch.zeros((4, 3), dtype=torch.int32)
        hist.hist_count(h, 2, 1, torch.from_numpy(base),
                        None if r is None else torch.from_numpy(r))
        assert got == int(h[2, 1])
        if r is not None:
            jh = _count_rows_kernel(jnp.zeros((4, 3), jnp.int32),
                                    jnp.int32(2), jnp.int32(1),
                                    jnp.asarray(r), jnp.asarray(base))
            assert got == int(np.asarray(jh)[2, 1])


@pytest.mark.parametrize("ms,wave", [
    ([1_000_000], 1056), ([1_000_000, 0, 5, 4096, 4097], 1056),
    ([10**8, 10**6, 3], 1056), ([7] * 8, 2), ([0, 0], 8)])
def test_k5_count_plan(ms, wave):
    """One launch's blocks: a thread a 16-lane group, within one wave (a
    count past its share keeps at least one block); none for no lanes."""
    plan = hist.count_plan(ms, wave)
    for m, b in zip(ms, plan):
        assert (b == 0) == (m == 0)
        assert b <= max(1, -(-m // (16 * THREADS)))
    if sum(-(-m // (16 * THREADS)) for m in ms) > wave:
        assert sum(plan) <= wave + len(ms)


def test_k5_many_equals_plain_and_jax():
    """1 to 9 counts (past 8 the wrapper's second launch), empty and
    short entries, into two tensors; each as JAX counts it."""
    rng = np.random.default_rng(5)
    entries, want = [], {}
    ha = torch.zeros((6, 4), dtype=torch.int32)
    hb = torch.zeros((1, 2), dtype=torch.int32)
    jh = {"a": jnp.zeros((6, 4), jnp.int32), "b": jnp.zeros((1, 2), jnp.int32)}
    for k, m in enumerate([100, 0, 9, 5000, 16, 1, 333, 64, 70]):
        base = rng.random(m) < 0.5
        rows = rng.integers(-3, 9, m).astype(np.int32)
        name, h = ("a", ha) if k % 3 else ("b", hb)
        slot, bucket = (k % 6, k % 4) if name == "a" else (0, k % 2)
        entries.append((h, slot, bucket, torch.from_numpy(base),
                        torch.from_numpy(rows)))
        jh[name] = _count_rows_kernel(jh[name], jnp.int32(slot),
                                      jnp.int32(bucket), jnp.asarray(rows),
                                      jnp.asarray(base))
        blocks = hist.count_plan([max(m, 1)], 4)[0]
        want[k] = emulate_count(base, rows, k, blocks)
    before = hist.hist_count.launches
    hist.hist_count_many(entries)
    assert hist.hist_count.launches == before  # the CPU: plain
    np.testing.assert_array_equal(ha.numpy(), np.asarray(jh["a"]))
    np.testing.assert_array_equal(hb.numpy(), np.asarray(jh["b"]))
    assert int(ha.sum() + hb.sum()) == sum(want.values())


# -- the fused window's deferred counts, against JAX --------------------------

def test_fused_window_counts_at_tick_end_equal_jax(run, monkeypatch):
    """A Presence window with cold emits (misses) and the ledger on: the
    counts wait for each tick's end and go out in one multi-count (one
    call a tick, the discovery tick included), and the ledger, the miss
    total and the delivered total equal the JAX window's."""
    calls = []
    real = port_fused.hist_count_many

    def recording(entries):
        calls.append(len(entries))
        real(entries)

    monkeypatch.setattr(port_fused, "hist_count_many", recording)

    async def main():
        import samples.presence  # noqa: F401 — registers the JAX types
        from orleans_tpu_torch.samples import presence  # noqa: F401

        je = JaxTensorEngine(
            config=JaxEngineConfig(tick_interval=0.0, auto_fusion_ticks=0),
            metrics=JaxMetricsConfig(attribution_enabled=False))
        pe = TensorEngine(device="cpu",
                          config=TensorEngineConfig(auto_fusion_ticks=0),
                          metrics=MetricsConfig(attribution_enabled=False))
        players = np.arange(60, dtype=np.int64)
        games = np.where(players % 3 == 0, 7, players % 5).astype(np.int32)
        out = []
        for engine, ticks, static in (
                (je, {"tick": jnp.arange(1, 4, dtype=jnp.int32)},
                 {"game": jnp.asarray(games),
                  "score": jnp.ones(60, jnp.float32)}),
                (pe, {"tick": torch.arange(1, 4, dtype=torch.int32)},
                 {"game": torch.from_numpy(games),
                  "score": torch.ones(60)})):
            engine.arena_for("PresenceGrain").resolve_rows(players)
            engine.arena_for("GameGrain").resolve_rows(
                np.arange(5, dtype=np.int64))
            prog = engine.fuse_ticks("PresenceGrain", "heartbeat", players)
            prog.run(ticks, static_args=static)
            prog.run(ticks, static_args=static)
            out.append((prog.verify(), engine.messages_processed,
                        engine.ledger.snapshot()))
        return out

    (jmiss, jmsgs, jled), (pmiss, pmsgs, pled) = run(main())
    assert pmiss == jmiss > 0
    assert pmsgs == jmsgs
    assert set(pled) == set(jled)
    for name, w in jled.items():
        assert pled[name]["counts"] == w["counts"], name
        assert pled[name]["total"] == w["total"], name
    # discovery, then 2 windows of 3 ticks: one multi-count a tick
    assert len(calls) == 1 + 2 * 3
    assert min(calls) >= 2
