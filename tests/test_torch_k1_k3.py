"""K1 ``resolve_dense`` and K3 ``row_scatter`` on the CPU: what the CUDA
kernels compute is emulated in numpy, step by step as the kernels take
it, and held against the plain versions and the JAX functions.

* K3's plan: ``scatter_plan`` picks direct or privatized from shapes alone
  (SET always direct; ADD and MAX privatized from a number of elements a
  word up to K4's 128 KiB of shared memory); the cluster's split covers
  each word once.
* K3's direct path: a warp's runs of 128 elements, 4 a thread strided by
  32; a warp where some lane shares its word with its neighbour or with
  lane 0 groups its lanes by word (``__match_any_sync``) and combines each
  group in a tree of shuffles (emulated round by round), one lane issuing
  the atomic; there the touch skips its atomic where a read of the word
  (stale or fresh) already holds the tick.  SET of one element a lane: a
  scalar head up to the rows' 16-byte boundary, 16-byte groups (4 rows in
  a row on a 16-byte boundary of the column written at once), a scalar
  tail.
* K3's privatized path: each block's copy (sums, maxima of
  order-preserving int32 keys, or a mask of touched words), a warp on
  one word combined first, each cluster's copies combined and flushed
  once per touched word.
* K1: 4 lanes a thread, a scalar head up to the keys' 16-byte boundary
  where keys, valid flags and rows share their offset, word by word where
  they do not, the partial last group, misses summed per block.

int32 exactly (ADD wraps), float32 ADD within twice Higham's bound, NaN
under float32 MAX.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.tensor import arena as jarena
from orleans_tpu.tensor import engine as jengine
from orleans_tpu.tensor.vector_grain import scatter_add_rows as jax_add
from orleans_tpu.tensor.vector_grain import scatter_rows as jax_set
from orleans_tpu.tensor.vector_grain import seg_max as jax_seg_max
from orleans_tpu_torch.kernels import resolve, scatter
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.kernels.scatter import scatter_plan
from orleans_tpu_torch.kernels.segment import (
    SEG_BLOCK_BYTES,
    SEG_CLUSTER,
    SegPlan,
)

RUN = 32 * 4  # elements of a warp's run: 4 a thread, strided by 32
LANE = np.arange(32)
I32_MIN, I32_MAX = -2**31, 2**31 - 1


# -- the device arithmetic ----------------------------------------------------

def raises(old, v):
    """Whether max(old, v) differs from old (NaN propagates); elementwise."""
    old, v = np.asarray(old), np.asarray(v)
    if old.dtype == np.float32:
        return ~np.isnan(old) & (np.isnan(v) | (old < v))
    return old < v


def max_key(v: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving int32 key of MAX values."""
    v = np.asarray(v)
    if v.dtype == np.int32:
        return v.copy()
    b = v.astype(np.float32).view(np.int32)
    k = np.where(b >= 0, b, b ^ np.int32(0x7fffffff)).astype(np.int32)
    return np.where(np.isnan(v), np.int32(I32_MAX), k).astype(np.int32)


def from_key(k: np.ndarray, dt) -> np.ndarray:
    k = np.asarray(k, np.int32)
    if dt == np.int32:
        return k.copy()
    b = np.where(k >= 0, k, k ^ np.int32(0x7fffffff)).astype(np.int32)
    b = np.where(k == I32_MAX, np.int32(0x7fc00000), b).astype(np.int32)
    return b.view(np.float32)


def atomic_max(flat, w, v) -> None:
    """The global atomic MAX at distinct words ``w`` (int32 wraps nothing;
    float32: a NaN value makes the word NaN, a NaN word stays NaN)."""
    old = flat[w]
    flat[w] = np.where(raises(old, v), v, old)


def match_any(w: np.ndarray) -> np.ndarray:
    """``__match_any_sync``: each lane's mask of the lanes with its word."""
    eq = w[:, None] == w[None, :]
    return (eq * (1 << LANE)[None, :]).sum(axis=1).astype(np.int64)


def _popc(x) -> np.ndarray:
    return np.array([bin(int(v)).count("1") for v in x])


def _ffs(x) -> np.ndarray:
    """1-based index of the lowest set bit, 0 for none."""
    return np.array([(int(v) & -int(v)).bit_length() for v in x])


def combine_peers(peers: np.ndarray, x: np.ndarray, op) -> np.ndarray:
    """``combine_peers`` of csrc/scatter.cu, round by round: every lane
    reads its nearest remaining peer above by a shuffle and combines
    (``op``, a numpy ufunc: int32 adds wrap); the lanes at odd places drop
    out of their groups after each round."""
    rel = _popc(peers & ((1 << LANE) - 1))
    above = peers & ((0xfffffffe << LANE) & 0xffffffff)
    while np.any(above != 0):
        nxt = _ffs(above)
        t = x[np.where(nxt > 0, nxt - 1, LANE)]  # all read, then all write
        x = np.where(nxt > 0, op(x, t), x).astype(x.dtype)
        ballot = int(((rel & 1) == 0).astype(np.int64) @ (1 << LANE))
        above = above & ballot
        rel = rel >> 1
    return x


def _leaders(peers: np.ndarray) -> np.ndarray:
    return (peers & ((1 << LANE) - 1)) == 0


# -- K3 -----------------------------------------------------------------------

def _warp_slots(total: int):
    """The warp slots in order, each the element indices of the 32 lanes
    (-1 past the end): runs of 128 elements, 4 a thread strided by 32."""
    for r, base in enumerate(range(0, total, RUN)):
        for j in range(4):
            e = base + 32 * j + LANE
            yield r, np.where(e < total, e, -1)


def _words(rows: np.ndarray, n: int, inner: int) -> np.ndarray:
    """Each element's column word, -1 where its lane's row is dropped."""
    e = np.arange(len(rows) * inner)
    lane = e // inner
    r = rows[lane].astype(np.int64) if len(rows) else np.zeros(0, np.int64)
    return np.where((r >= 0) & (r < n), r * inner + e - lane * inner, -1)


def _elem_values(values, m, inner, dt) -> np.ndarray:
    if np.ndim(values) == 0:
        return np.full(m * inner, values, dt)
    return np.asarray(values, dt).reshape(-1)


def _slot(e, w, v, scalar, dt):
    """A slot's words and values (the broadcast value past the end)."""
    ws = np.where(e >= 0, w[np.maximum(e, 0)], -1) if len(w) else \
        np.full(32, -1, np.int64)
    vs = np.where(e >= 0, v[np.maximum(e, 0)], scalar) if len(v) else \
        np.full(32, scalar, dt)
    return ws, vs.astype(dt)


def emulate_direct(col, rows, values, op, rng, stale=0.5):
    """K3's direct path for ADD, MAX and SET of [inner] lanes, slot by
    slot; the touch's L2 read sees the column as it was before the launch
    with probability ``stale``."""
    col = col.copy()
    n, inner = col.shape[0], int(np.prod(col.shape[1:], dtype=np.int64))
    flat = col.reshape(-1)
    before = flat.copy()
    dt = flat.dtype.type
    m = len(rows)
    touch = op == "max" and np.ndim(values) == 0
    scalar = dt(values) if np.ndim(values) == 0 else dt(0)
    w = _words(rows, n, inner)
    v = _elem_values(values, m, inner, dt)
    with np.errstate(over="ignore", invalid="ignore"):
        for _, e in _warp_slots(m * inner):
            ws, vs = _slot(e, w, v, scalar, dt)
            if op == "set":
                keep = ws >= 0
                flat[ws[keep]] = vs[keep]
                continue
            lo = ws.astype(np.int32)   # the low 32 bits, compared
            near = (lo == lo[LANE ^ 1]) | ((LANE != 0) & (lo == lo[0]))
            lead = np.ones(32, bool)
            shared = bool(np.any((ws >= 0) & near))
            if shared:
                peers = match_any(ws)
                if op == "add":
                    vs = combine_peers(peers, vs, np.add)
                elif not touch:
                    vs = from_key(combine_peers(peers, max_key(vs),
                                                np.maximum), dt)
                lead = _leaders(peers)
            # the issuing lanes' atomics land in any order (repeats the
            # check missed add or max one by one)
            sel = rng.permutation(np.nonzero(lead & (ws >= 0))[0])
            wl, vl = ws[sel], vs[sel]
            if op == "add":
                np.add.at(flat, wl, vl)
                continue
            if touch and shared:
                seen = np.where(rng.random(len(wl)) < stale, before[wl],
                                flat[wl])
                go = raises(seen, vl)
                wl, vl = wl[go], vl[go]
            np.maximum.at(flat, wl, vl)   # NaN propagates, as atomic_max
    return flat.reshape(col.shape)


def emulate_private(col, rows, values, op, plan, n_clusters=3):
    """K3's privatized path: runs dealt to the blocks in turn, each block's
    copy folded slot by slot (a slot whose 32 elements share one word
    combined first), each cluster's copies combined and flushed once per
    touched word."""
    col = col.copy()
    n, inner = col.shape[0], int(np.prod(col.shape[1:], dtype=np.int64))
    flat = col.reshape(-1)
    dt = flat.dtype.type
    m, words = len(rows), n * inner
    touch = op == "max" and np.ndim(values) == 0
    mode = "add" if op == "add" else "touch" if touch else "max"
    scalar = dt(values) if np.ndim(values) == 0 else dt(0)
    w = _words(rows, n, inner)
    v = _elem_values(values, m, inner, dt)
    n_blocks = n_clusters * plan.cluster
    size = plan.cluster * plan.chunk
    assert size >= words
    hist = np.zeros((n_blocks, size), dt if mode == "add" else np.int32)
    if mode == "max":
        hist[:] = I32_MIN
    with np.errstate(over="ignore", invalid="ignore"):
        for run, e in _warp_slots(m * inner):
            h = hist[run % n_blocks]
            ws, vs = _slot(e, w, v, scalar, dt)
            keep = ws >= 0
            if mode == "touch":
                h[ws[keep]] = 1
                continue
            x = vs if mode == "add" else max_key(vs)
            if np.all(ws == ws[0]):   # a warp on one word: shuffles first
                if ws[0] >= 0:
                    if mode == "add":
                        h[ws[:1]] += np.add.reduce(x, dtype=x.dtype)
                    else:
                        h[ws[0]] = max(h[ws[0]], x.max())
            elif mode == "add":
                np.add.at(h, ws[keep], x[keep])
            else:
                np.maximum.at(h, ws[keep], x[keep])
        for c in range(n_clusters):
            copies = hist[c * plan.cluster:(c + 1) * plan.cluster, :words]
            if mode == "max":
                combined = copies.max(axis=0)
            else:
                combined = copies[0].copy()
                for b in copies[1:]:
                    combined = combined + b
            touched = np.nonzero(combined != (I32_MIN if mode == "max"
                                              else 0))[0]
            if mode == "add":
                flat[touched] = flat[touched] + combined[touched]
            elif mode == "touch":
                atomic_max(flat, touched, np.full(len(touched), scalar))
            else:
                atomic_max(flat, touched, from_key(combined[touched], dt))
    return flat.reshape(col.shape)


def emulate_set(col, rows, values, rows_off: int, col_off: int):
    """K3's SET of one element a lane: the rows view starts ``rows_off``
    lanes past a 16-byte boundary and the column ``col_off`` words past
    one; returns the column and how many groups stored 16 bytes at once."""
    col = col.copy()
    dt = col.dtype.type
    m, n = len(rows), col.shape[0]
    v = _elem_values(values, m, 1, dt)
    head = min((4 - rows_off) % 4, m)
    groups = (m - head) // 4
    tail = m - head - 4 * groups
    whole = 0
    for i in list(range(head)) + list(range(m - tail, m)):
        if 0 <= rows[i] < n:
            col[rows[i]] = v[i]
    for g in range(groups):
        r = rows[head + 4 * g:head + 4 * g + 4].astype(np.int64)
        x = v[head + 4 * g:head + 4 * g + 4]
        if r[0] >= 0 and r[3] < n and np.all(r == r[0] + np.arange(4)) \
                and (col_off + r[0]) % 4 == 0:
            col[r[0]:r[0] + 4] = x
            whole += 1
            continue
        for j in range(4):
            if 0 <= r[j] < n:
                col[r[j]] = x[j]
    return col, whole


def _rows_case(kind, rng):
    """(rows, n, inner) of each case, with dropped lanes: -1, n, n + 5,
    the sentinel and -2**31."""
    n, m, inner = {"uniform": (100, 3000, 1), "one_row": (1, 2000, 1),
                   "hot": (64, 3000, 1), "inner": (50, 1500, 3),
                   "sinks": (1024, 6000, 1), "m0": (40, 0, 1),
                   "m1": (40, 1, 1), "m3": (40, 3, 1),
                   "m5": (40, 5, 1)}[kind]
    rows = rng.integers(0, 256 if kind == "sinks" else n, m).astype(np.int32)
    if kind == "hot":
        rows[:2000] = 17   # whole warps on one word
    bad = rng.random(m) < 0.1
    if kind in ("m1", "m3", "m5"):
        bad[0] = True
    rows[bad] = rng.choice(np.array([-1, n, n + 5, KEY_SENTINEL, I32_MIN],
                                    np.int32), bad.sum())
    return rows, n, inner


def _values(form, dtype, m, inner, rng):
    shape = (m,) if inner == 1 else (m, inner)
    if form == "scalar":
        return dtype(9) if dtype == np.int32 else dtype(0.75)
    if dtype == np.int32:
        return rng.integers(I32_MIN, I32_MAX, shape, dtype=np.int64).astype(
            np.int32)
    vals = rng.standard_normal(shape).astype(np.float32)
    vals.reshape(-1)[rng.random(m * inner) < 0.002] = np.nan
    return vals


def _fan_in_tol(values, rows, n, base):
    """Twice Higham's bound per column element over its k terms (the
    kept lanes and the column's own value)."""
    keep = (rows >= 0) & (rows < n)
    inner = base.reshape(n, -1).shape[1]
    vals = np.broadcast_to(np.asarray(values, np.float32),
                           (len(rows), inner) if inner > 1 else (len(rows),))
    flat = np.abs(vals[keep].reshape(keep.sum(), inner)).astype(np.float64)
    k = np.bincount(rows[keep], minlength=n)[:, None] + 1
    mag = np.stack([np.bincount(rows[keep], weights=flat[:, j], minlength=n)
                    for j in range(inner)], axis=1) \
        + np.abs(base.reshape(n, inner)).astype(np.float64)
    return (2 * (k - 1) * 2.0**-24 * mag).reshape(base.shape)


def _same(got, want, op, rows, values, base):
    if op == "add" and got.dtype == np.float32:
        tol = _fan_in_tol(values, rows, base.shape[0], base)
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert np.all((diff <= tol) | (np.isnan(got) & np.isnan(want)))
    elif got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(got[ok], want[ok])
    else:
        np.testing.assert_array_equal(got, want)


def _plain(col, rows, values, op):
    v = torch.from_numpy(np.ascontiguousarray(values)) \
        if np.ndim(values) else values
    return scatter.row_scatter_plain(torch.from_numpy(col.copy()),
                                     torch.from_numpy(rows), v, op).numpy()


def _jax(col, rows, values, op, lanes=8192, words=1024):
    """JAX's answer: scatter_add_rows; for MAX ``_touch_kernel`` (a
    broadcast tick) or ``seg_max`` folded into the column.  Lanes are
    padded with dropped rows and the column with rows no lane keeps, so
    every case of a dtype and width compiles once."""
    n, m = col.shape[0], len(rows)
    assert m <= lanes and n <= words
    pad = np.zeros((words - n, *col.shape[1:]), col.dtype)
    big = jnp.asarray(np.concatenate([col, pad]))
    kept = np.where((rows >= 0) & (rows < n), rows, -1)
    safe = jnp.asarray(np.concatenate([kept, np.full(lanes - m, -1,
                                                     np.int32)]))
    vals = np.zeros((lanes, *col.shape[1:]), col.dtype)
    vals[:m] = np.broadcast_to(values, (m, *col.shape[1:]))
    if op == "add":
        return np.asarray(jax_add(big, safe, jnp.asarray(vals)))[:n]
    if np.ndim(values) == 0:
        return np.asarray(jarena._touch_kernel(big, safe, values))[:n]
    top = np.asarray(jax_seg_max(jnp.asarray(vals), safe, words))[:n]
    return np.where(np.isnan(col) | np.isnan(top), np.nan,
                    np.maximum(col, top)).astype(col.dtype) \
        if col.dtype == np.float32 else np.maximum(col, top)


def _forced(path, n, inner):
    if path == "direct":
        return SegPlan(0, 0, *scatter.SCATTER_DIRECT)
    cluster = {"private": SEG_CLUSTER, "private2": 2}[path]
    chunk = -(-max(n * inner, 1) // cluster)
    return SegPlan(cluster, -(-chunk // 4) * 4, *scatter.SCATTER_PRIVATE)


# -- the plan -----------------------------------------------------------------

def test_k3_path_from_shapes():
    """The smoke's shapes: the touch of Presence's games, the routing
    sample's sinks and hot sink and the float fan-ins onto GameGrain's
    rows privatized; every SET, the heartbeats and the touch of the
    players (distinct rows on 2M) direct."""
    cap_p, cap_g = 1 << 21, 1 << 15
    for m, n, op, scalar in ((1 << 20, cap_g, "max", True),
                             (1 << 20, 1024, "max", True),
                             (1 << 20, cap_g, "add", False),
                             (1 << 20, cap_g, "max", False)):
        plan = scatter_plan(m, n, 1, op, scalar)
        assert plan.cluster == SEG_CLUSTER, (m, n, op)
        assert plan.cluster * plan.chunk >= n and plan.chunk % 4 == 0
    for m, n, op, scalar in ((1 << 20, cap_p, "set", False),
                             (1 << 20, cap_p, "set", True),
                             (1 << 20, 1024, "set", False),
                             (1 << 20, cap_p, "add", False),
                             (1 << 20, cap_p, "max", True)):
        assert scatter_plan(m, n, 1, op, scalar).cluster == 0, (m, n, op)


def test_k3_plan_thresholds():
    """At the edge of each threshold: elements a word (for the lanes'
    own values and for the touch), the column's bytes, an empty column or
    input; inner counts elements; shapes alone decide."""
    per = scatter.SCATTER_MIN_PER_WORD
    for op in ("add", "max"):
        for scalar in (False, True):
            assert scatter_plan(per * 100, 100, 1, op, scalar).cluster
            assert scatter_plan(per * 100 - 1, 100, 1, op,
                                scalar).cluster == 0
            assert scatter_plan(per * 100, 100, 4, op, scalar).cluster
            assert scatter_plan(per * 100 - 1, 100, 4, op,
                                scalar).cluster == 0
    words = SEG_BLOCK_BYTES // 4
    assert scatter_plan(per * words, words, 1, "add", False).cluster
    assert scatter_plan(per * (words + 1), words + 1, 1, "add",
                        False).cluster == 0
    assert scatter_plan(per * words, words // 4, 4, "max", False).cluster
    assert scatter_plan(per * words, words // 2, 4, "max",
                        False).cluster == 0
    assert scatter_plan(10**7, 10, 1, "set", False).cluster == 0
    assert scatter_plan(0, 100, 1, "add", False).cluster == 0
    assert scatter_plan(10**6, 0, 1, "add", False).cluster == 0
    assert scatter_plan(10**6, 1, 1, "max", True) == \
        scatter_plan(10**7, 1, 1, "max", True)
    with pytest.raises(ValueError):
        scatter_plan(10, 10, 1, "min", False)


@pytest.mark.parametrize("words", [1, 3, 4, 5, 255, 1024, 10_001, 32_768])
def test_k3_cluster_split_covers_each_word_once(words):
    plan = scatter_plan(scatter.SCATTER_MIN_PER_WORD * words, words, 1,
                        "add", False)
    assert plan.cluster and plan.chunk % 4 == 0
    assert 0 <= plan.cluster * plan.chunk - words < 4 * plan.cluster
    assert 4 * plan.cluster * plan.chunk <= SEG_BLOCK_BYTES + 16 * plan.cluster
    hit = np.zeros(words, np.int64)
    for r in range(plan.cluster):
        hit[min(r * plan.chunk, words):min((r + 1) * plan.chunk, words)] += 1
    np.testing.assert_array_equal(hit, 1)


# -- the warp's combine and the MAX keys --------------------------------------

@pytest.mark.parametrize("kind", ["distinct", "one", "pairs", "random",
                                  "runs"])
def test_combine_peers_leaves_each_group_whole_on_its_first_lane(kind):
    rng = np.random.default_rng(["distinct", "one", "pairs", "random",
                                 "runs"].index(kind))
    for _ in range(20):
        w = {"distinct": rng.permutation(32), "one": np.zeros(32, int),
             "pairs": LANE // 2, "random": rng.integers(0, 5, 32),
             "runs": np.sort(rng.integers(0, 9, 32))}[kind].astype(np.int64)
        x = rng.integers(-1000, 1000, 32).astype(np.int64)
        peers = match_any(w)
        got_sum = combine_peers(peers, x, np.add)
        got_max = combine_peers(peers, x, np.maximum)
        for lane in np.nonzero(_leaders(peers))[0]:
            group = w == w[lane]
            assert got_sum[lane] == x[group].sum()
            assert got_max[lane] == x[group].max()
        assert _leaders(peers).sum() == len(np.unique(w))


def test_max_keys_order_floats_and_mark_untouched():
    vals = np.array([-np.inf, -3e38, -1.5, -1e-45, -0.0, 0.0, 1e-45, 2.0,
                     3e38, np.inf], np.float32)
    keys = max_key(vals)
    assert np.all(np.diff(keys.astype(np.int64)) > 0)
    np.testing.assert_array_equal(from_key(keys, np.float32).view(np.int32),
                                  vals.view(np.int32))
    nan = np.array([np.nan, -np.nan], np.float32)
    assert np.all(max_key(nan) == I32_MAX)
    assert np.isnan(from_key(max_key(nan), np.float32)).all()
    bits = np.random.default_rng(0).integers(I32_MIN, I32_MAX, 100_000,
                                             dtype=np.int64).astype(np.int32)
    f = bits.view(np.float32)
    assert np.all(max_key(f) > I32_MIN)   # INT32_MIN is no float's key
    ok = ~np.isnan(f)
    order = np.argsort(f[ok], kind="stable")
    assert np.all(np.diff(max_key(f[ok])[order].astype(np.int64)) >= 0)


# -- K3 against the plain version and JAX -------------------------------------

K3_KINDS = ["uniform", "one_row", "hot", "inner", "sinks", "m0", "m1", "m3",
            "m5"]


@functools.lru_cache(maxsize=None)
def _k3_reference(kind, op, dtype, form):
    """A case's inputs with the plain version's and JAX's answers (shared
    by the paths of one case)."""
    rng = np.random.default_rng([K3_KINDS.index(kind), len(op), len(form),
                                 int(dtype == np.int32)])
    rows, n, inner = _rows_case(kind, rng)
    values = _values(form, dtype, len(rows), inner, rng)
    shape = (n, inner) if inner > 1 else (n,)
    base = rng.integers(-1000, 1000, shape).astype(dtype)
    if dtype == np.float32 and n > 3:
        base.reshape(-1)[3] = np.nan
    return (rows, n, inner, values, base, _plain(base, rows, values, op),
            _jax(base, rows, values, op))


@pytest.mark.parametrize("form", ["lanes", "scalar"])
@pytest.mark.parametrize("path", ["planned", "direct", "private",
                                  "private2"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("kind", K3_KINDS)
def test_k3_emulation_equals_plain_and_jax(kind, op, dtype, path, form):
    """ADD and MAX on each path (the planned one, direct, clusters of 8
    and of 2), with lane values (full-range int32, so ADD wraps; float32
    with NaN) and with a broadcast scalar (MAX of it is the touch)."""
    rows, n, inner, values, base, plain, want = _k3_reference(
        kind, op, dtype, form)
    plan = scatter_plan(len(rows), n, inner, op, form == "scalar") \
        if path == "planned" else _forced(path, n, inner)
    rng = np.random.default_rng(len(path))
    got = emulate_direct(base, rows, values, op, rng) if plan.cluster == 0 \
        else emulate_private(base, rows, values, op, plan)
    _same(got, plain, op, rows, values, base)
    _same(got, want, op, rows, values, base)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_k3_touch_reads_stale_or_fresh_alike(dtype):
    """The touch's read filter: every read stale, every read fresh, or a
    mix, on a hot row and on spread rows, gives the same column."""
    rng = np.random.default_rng(5)
    rows = rng.integers(-1, 40, 5000).astype(np.int32)
    rows[:1000] = 7
    base = rng.integers(0, 20, 40).astype(dtype)
    want = _plain(base, rows, dtype(12), "max")
    for stale in (0.0, 0.5, 1.0):
        got = emulate_direct(base, rows, dtype(12), "max", rng, stale)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows_off", [0, 1, 2, 3])
@pytest.mark.parametrize("col_off", [0, 1])
@pytest.mark.parametrize("m", [0, 1, 3, 5, 4099])
@pytest.mark.parametrize("form", ["lanes", "scalar"])
def test_k3_set_emulation_equals_plain_and_jax(m, rows_off, col_off, form):
    """SET of one element a lane: the head, the 16-byte groups (runs of
    rows in order, on and off the column's 16-byte boundaries) and the
    tail, with distinct rows and dropped lanes; duplicate rows keep one of
    their writers."""
    rng = np.random.default_rng([m, rows_off, col_off, len(form)])
    n = 8192
    rows = rng.permutation(n)[:m].astype(np.int32)
    if m > 2000:
        rows[:1000] = np.arange(100, 1100)
        rest = rng.permutation(np.setdiff1d(np.arange(n), np.arange(100,
                                                                    1100)))
        rows[1000:] = rest[:m - 1000]
    rows[rng.random(m) < 0.1] = rng.choice(np.array([-1, n, KEY_SENTINEL],
                                                    np.int32))
    values = rng.integers(-999, 999, m).astype(np.int32) \
        if form == "lanes" else np.int32(-7)
    base = rng.integers(0, 50, n).astype(np.int32)
    got, whole = emulate_set(base, rows, values, rows_off, col_off)
    np.testing.assert_array_equal(got, _plain(base, rows, values, "set"))
    safe = np.where(rows >= n, -1, rows)
    vals = np.broadcast_to(values, (m,))
    np.testing.assert_array_equal(got, np.asarray(jax_set(
        jnp.asarray(base), jnp.asarray(safe), jnp.asarray(vals))))
    head = min((4 - rows_off) % 4, m)
    if m > 2000 and (col_off + head) % 4 == 0:
        assert whole > 0   # the run's groups land on 16-byte boundaries
    # duplicates: each row ends with one of its writers' values
    dup = rng.integers(0, 16, 300).astype(np.int32)
    vals = rng.integers(0, 10**6, 300).astype(np.int32)
    got, _ = emulate_set(base, dup, vals, rows_off, col_off)
    for r in np.unique(dup):
        assert got[r] in vals[dup == r]


# -- K1 -----------------------------------------------------------------------

def emulate_k1(dense, keys, valid, keys_off, valid_off, rows_off,
               threads=64, blocks=3):
    """K1 as the kernel takes it: views ``*_off`` lanes (valid: bytes)
    past a 16-byte boundary; head and 16-byte groups where the three
    agree, word-by-word groups where not; 4 lanes a thread over a
    persistent grid; misses summed per block, one add a block."""
    m, size = len(keys), len(dense)
    head = min((4 - keys_off) % 4, m)
    vec = head < m and (rows_off + head) % 4 == 0 \
        and (valid_off + head) % 4 == 0
    if not vec:
        head = 0
    rows = np.full(m, 12345, np.int32)
    block_misses = np.zeros(blocks, np.int64)

    def one(i, b):
        k, v = keys[i], bool(valid[i])
        live = v and k < KEY_SENTINEL
        in_range = live and 0 <= k < size
        r = dense[k] if in_range else -1
        block_misses[b] += (in_range and r >= 0) != live
        rows[i] = r

    stride = threads * blocks
    for t in range(stride):
        b = t // threads
        if t < head:
            one(t, b)
        for g in range(t, (m - head + 3) // 4, stride):
            for j in range(4):
                if head + 4 * g + j < m:
                    one(head + 4 * g + j, b)
    return rows, int(block_misses.sum())


@pytest.mark.parametrize("m", [0, 1, 3, 5, 4099])
@pytest.mark.parametrize("offs", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                  (1, 0, 1), (2, 2, 0), (0, 1, 0)])
def test_k1_emulation_equals_plain_and_jax(m, offs):
    """4 lanes a thread with the head, the partial last group and
    mismatched offsets (word by word), exactly: rows and the miss count."""
    rng = np.random.default_rng([m, *offs])
    size = 1 << 10
    dense = rng.permutation(size).astype(np.int32)
    dense[rng.random(size) < 0.2] = -1
    keys = rng.integers(-10, size + 10, m).astype(np.int32)
    keys[rng.random(m) < 0.05] = KEY_SENTINEL
    valid = rng.random(m) < 0.9
    got_rows, got_miss = emulate_k1(dense, keys, valid, *offs)
    plain_rows, plain_miss = resolve.resolve_dense_plain(
        torch.from_numpy(dense), torch.from_numpy(keys),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(got_rows, plain_rows.numpy())
    assert got_miss == int(plain_miss)
    jax_rows, jax_miss = jengine._resolve_rows_dense_kernel(
        jnp.asarray(dense), jnp.asarray(keys), jnp.asarray(valid))
    np.testing.assert_array_equal(got_rows, np.asarray(jax_rows))
    assert got_miss == int(jax_miss)
