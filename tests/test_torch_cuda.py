"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips where there is none (such as the CPU-only tier-1 run).  On a machine
with an H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist

Integers must match exactly; float32 sums within twice Higham's bound,
``2 * (k - 1) * 2**-24 * sum|x|`` per row, since the atomic order of the
kernel differs from the plain version's.
"""

import numpy as np
import pytest
import torch

from orleans_tpu_torch.kernels import resolve, scatter, segment
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL

pytestmark = pytest.mark.cuda

N_ROWS, M = 4096, 50_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rows(rng, n, m, unique=False):
    rows = (rng.permutation(n)[:m] if unique else rng.integers(0, n, m))
    rows = rows.astype(np.int32)
    bad = rng.random(len(rows)) < 0.1
    rows[bad] = rng.choice(np.array([-1, n, KEY_SENTINEL], np.int32),
                           bad.sum())
    return rows


def _fan_in_tol(values, rows, n, base=None):
    """Twice Higham's bound per row over its k terms: the kept lanes, plus
    ``base`` (the column before an in-place add) when given."""
    keep = (rows >= 0) & (rows < n)
    k = np.bincount(rows[keep], minlength=n)
    mag = np.bincount(rows[keep], weights=np.abs(values[keep]).astype(
        np.float64), minlength=n)
    if base is not None:
        k, mag = k + 1, mag + np.abs(base)
    return 2 * np.maximum(k - 1, 0) * 2.0**-24 * mag


@pytest.mark.parametrize("kind", ["dense", "sorted", "sorted_empty"])
def test_resolve_kernels_match_plain(cuda_device, kind):
    rng = np.random.default_rng(0)
    keys = rng.integers(-10, 2 * N_ROWS, M).astype(np.int32)
    keys[rng.random(M) < 0.05] = KEY_SENTINEL
    valid = rng.random(M) < 0.9
    k_d = torch.from_numpy(keys).to(cuda_device)
    v_d = torch.from_numpy(valid).to(cuda_device)
    if kind == "dense":
        dense = rng.permutation(N_ROWS).astype(np.int32)
        dense[rng.random(N_ROWS) < 0.2] = -1
        args = (torch.from_numpy(dense).to(cuda_device),)
        kernel, plain = resolve.resolve_dense, resolve.resolve_dense_plain
    else:
        live = 0 if kind == "sorted_empty" else N_ROWS // 2
        sk = np.full(N_ROWS, KEY_SENTINEL, np.int32)
        sk[:live] = np.sort(rng.choice(2 * N_ROWS, live, replace=False))
        sr = np.full(N_ROWS, -1, np.int32)
        sr[:live] = rng.permutation(N_ROWS)[:live]
        args = (torch.from_numpy(sk).to(cuda_device),
                torch.from_numpy(sr).to(cuda_device))
        kernel, plain = resolve.resolve_sorted, resolve.resolve_sorted_plain
    rows, miss = kernel(*args, k_d, v_d)
    want_rows, want_miss = plain(*args, k_d, v_d)
    torch.cuda.synchronize()
    assert torch.equal(rows, want_rows)
    assert int(miss) == int(want_miss)


def _sorted_mirror(rng, n, fill):
    """A sorted mirror of ``n`` entries: ``fill`` "half" live keys then
    sentinels, "empty" all sentinels (the cold tick), "full" no padding;
    live keys spread over int32, negative ones and -2**31 included."""
    live = {"half": n // 2, "empty": 0, "full": n}[fill]
    keys = np.unique(rng.integers(-2**31, KEY_SENTINEL, 2 * live + 8))
    keys = np.sort(rng.choice(keys, live, replace=False)).astype(np.int32)
    if live:
        keys[0] = -2**31
    sk = np.full(n, KEY_SENTINEL, np.int32)
    sk[:live] = keys
    sr = np.full(n, -1, np.int32)
    sr[:live] = rng.permutation(n)[:live]
    return sk, sr


def _sorted_lanes(rng, sk, m):
    """Lanes hitting live keys, their neighbours, -2**31, negative keys,
    the sentinel and keys past the last live key."""
    live = sk[sk < KEY_SENTINEL]
    pick = rng.integers(0, 6, m)
    keys = rng.integers(-2**31, KEY_SENTINEL, m).astype(np.int64)
    if len(live):
        at = live[rng.integers(0, len(live), m)].astype(np.int64)
        keys = np.where(pick == 0, at, keys)
        keys = np.where(pick == 1, np.clip(at + 1, -2**31, 2**31 - 1), keys)
        keys = np.where(pick == 2, int(live[-1]) + rng.integers(1, 9, m),
                        keys)
    keys = np.where(pick == 3, -2**31, keys)
    keys = np.where(pick == 4, KEY_SENTINEL, keys)
    keys = np.clip(keys, -2**31, 2**31 - 1).astype(np.int32)
    return keys, rng.random(m) < 0.9


@pytest.mark.parametrize("fill", ["half", "empty", "full"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 32768, 524288])
def test_resolve_sorted_mirror_sizes_match_plain(cuda_device, n, fill):
    """K2 on both sides of the whole-mirror tree (4,095 keys) and with
    buckets of 8 and 128 keys, on padded, all-sentinel and unpadded
    mirrors; the lane count is not a multiple of 4."""
    rng = np.random.default_rng(n)
    sk, sr = _sorted_mirror(rng, n, fill)
    keys, valid = _sorted_lanes(rng, sk, 20_003)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (sk, sr, keys, valid)]
    rows, miss = resolve.resolve_sorted(*args)
    want_rows, want_miss = resolve.resolve_sorted_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(rows, want_rows)
    assert int(miss) == int(want_miss)


@pytest.mark.parametrize("m", [0, 1, 5, 4099])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_resolve_sorted_lane_edges_match_plain(cuda_device, m, offset):
    """K2 on short lane counts, on key and valid views that start off
    the 16- and 4-byte boundaries, adding into a given ``misses``."""
    rng = np.random.default_rng(m + offset)
    sk, sr = _sorted_mirror(rng, 32768, "half")
    keys, valid = _sorted_lanes(rng, sk, m + offset)
    sk_d, sr_d = (torch.from_numpy(a).to(cuda_device) for a in (sk, sr))
    keys_d = torch.from_numpy(keys).to(cuda_device)[offset:]
    valid_d = torch.from_numpy(valid).to(cuda_device)[offset:]
    got_miss = torch.full((1,), 7, dtype=torch.int32, device=cuda_device)
    want_miss = got_miss.clone()
    rows, _ = resolve.resolve_sorted(sk_d, sr_d, keys_d, valid_d, got_miss)
    want_rows, _ = resolve.resolve_sorted_plain(sk_d, sr_d, keys_d, valid_d,
                                                want_miss)
    torch.cuda.synchronize()
    assert torch.equal(rows, want_rows)
    assert int(got_miss) == int(want_miss)


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["set", "add", "max"])
def test_row_scatter_matches_plain(cuda_device, op, dtype, scalar):
    rng = np.random.default_rng(1)
    rows = _rows(rng, N_ROWS, N_ROWS // 2 if op == "set" else M,
                 unique=(op == "set"))
    m = len(rows)
    if dtype == torch.int32:
        vals = rng.integers(-1000, 1000, m).astype(np.int32)
        base = rng.integers(-1000, 1000, N_ROWS).astype(np.int32)
    else:
        vals = rng.standard_normal(m).astype(np.float32)
        base = rng.standard_normal(N_ROWS).astype(np.float32)
    values = (np.int32(5) if dtype == torch.int32 else 0.5) if scalar \
        else torch.from_numpy(vals).to(cuda_device)
    r_d = torch.from_numpy(rows).to(cuda_device)
    col = torch.from_numpy(base).to(cuda_device)
    got = scatter.row_scatter(col.clone(), r_d, values, op)
    want = scatter.row_scatter_plain(col.clone(), r_d, values, op)
    if op == "add" and dtype == torch.float32:
        lane = np.full(m, 0.5, np.float32) if scalar else vals
        tol = _fan_in_tol(lane, rows, N_ROWS, base=base)
        assert np.all(np.abs((got - want).cpu().numpy()) <= tol)
    else:
        assert torch.equal(got, want)


# K4 forced onto each path: (cluster, threads, blocks per SM); None takes
# seg_plan's choice
_SEG_PATHS = {"planned": None, "direct": (0, 256, 32), "alone": (1, 256, 4),
              "cluster2": (2, 512, 2), "cluster8": (8, 512, 2),
              "cluster16": (16, 1024, 1)}


@pytest.mark.parametrize("shape", ["wide", "few_rows", "hot", "inner",
                                   "odd"])
@pytest.mark.parametrize("path", list(_SEG_PATHS))
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_seg_sum_matches_plain(cuda_device, dtype, path, shape, monkeypatch):
    """Every K4 path at small shapes: 4,096 rows, 300 rows (many lanes a
    word), a hot row that whole warps hit, [m, 3] lanes, and odd lengths."""
    rng = np.random.default_rng(2)
    n_rows, m, inner = {"wide": (N_ROWS, M, 1), "few_rows": (300, M, 1),
                        "hot": (300, M, 1), "inner": (700, M, 3),
                        "odd": (37, 1001, 1)}[shape]
    rows = _rows(rng, n_rows, m)
    if shape == "hot":
        rows[:40_000] = 123
    vshape = (m,) if inner == 1 else (m, inner)
    vals = rng.integers(-2**31, 2**31, vshape).astype(np.int32) \
        if dtype == torch.int32 else rng.standard_normal(vshape).astype(
            np.float32)
    forced = _SEG_PATHS[path]
    if forced is not None:
        cluster, threads, per_sm = forced
        chunk = -(-n_rows * inner // max(cluster, 1))
        plan = segment.SegPlan(cluster, -(-chunk // 4) * 4 if cluster else 0,
                               threads, per_sm)
        monkeypatch.setattr(segment, "seg_plan", lambda *a: plan)
    v_d = torch.from_numpy(vals).to(cuda_device)
    r_d = torch.from_numpy(rows).to(cuda_device)
    before = segment.seg_sum.launches
    got = segment.seg_sum(v_d, r_d, n_rows)
    torch.cuda.synchronize()
    assert segment.seg_sum.launches == before + 1
    want = segment.seg_sum_plain(v_d, r_d, n_rows)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        keep = (rows >= 0) & (rows < n_rows)
        for j in range(inner):
            col = vals if inner == 1 else vals[:, j]
            tol = _fan_in_tol(col, rows, n_rows)
            diff = (got - want).cpu().numpy().reshape(n_rows, inner)[:, j]
            assert np.all(np.abs(diff) <= tol)
        assert keep.any()


def test_wrappers_count_only_kernel_launches(cuda_device):
    rows = torch.zeros(4, dtype=torch.int32)
    before = scatter.row_scatter.launches
    scatter.row_scatter(torch.zeros(8, dtype=torch.int32), rows, 1, "add")
    assert scatter.row_scatter.launches == before  # CPU: plain version
    scatter.row_scatter(torch.zeros(8, dtype=torch.int32,
                                    device=cuda_device),
                        rows.to(cuda_device), 1, "add")
    assert scatter.row_scatter.launches == before + 1


# -- K3 device-scalar mode, K5, K6 ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["set", "add", "max"])
def test_row_scatter_device_scalar_matches_plain(cuda_device, op, dtype):
    """A 0-d device tensor is read through its pointer by every lane."""
    rng = np.random.default_rng(3)
    rows = _rows(rng, N_ROWS, N_ROWS // 2 if op == "set" else M,
                 unique=(op == "set"))
    base = rng.integers(-1000, 1000, (N_ROWS, 2)).astype(np.int32)
    col = torch.from_numpy(base).to(cuda_device).to(dtype)
    r_d = torch.from_numpy(rows).to(cuda_device)
    value = torch.tensor(5, dtype=dtype, device=cuda_device)
    got = scatter.row_scatter(col.clone(), r_d, value, op)
    want = scatter.row_scatter_plain(col.clone(), r_d, value, op)
    assert torch.equal(got, want)  # 5 and the bases are exact in float32


@pytest.mark.parametrize("with_rows", [True, False])
def test_hist_count_matches_plain(cuda_device, with_rows):
    from orleans_tpu_torch.kernels import hist

    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.random(M) < 0.6).to(cuda_device)
    rows = torch.from_numpy(_rows(rng, N_ROWS, M)).to(cuda_device) \
        if with_rows else None
    h = torch.from_numpy(rng.integers(0, 9, (64, 16)).astype(
        np.int32)).to(cuda_device)
    got = hist.hist_count(h.clone(), 7, 3, base, rows)
    want = hist.hist_count_plain(h.clone(), 7, 3, base, rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["many_unique", "all_duplicate",
                                  "sentinel", "none", "large"])
def test_miss_keys_matches_plain(cuda_device, kind):
    """K6 against its plain version, with more unique misses than
    ``miss_buf``, all-duplicate keys, sentinel and negative lanes, no
    misses, and 300k lanes (many sort tiles)."""
    from orleans_tpu_torch.kernels import miss

    rng = np.random.default_rng(5)
    m = 300_000 if kind == "large" else M
    keys = rng.integers(-5, 40_000, m).astype(np.int32)
    if kind == "many_unique":
        keys = rng.permutation(4 * m)[:m].astype(np.int32)
    elif kind == "all_duplicate":
        keys[:] = 77
    elif kind == "sentinel":
        keys[rng.random(m) < 0.2] = KEY_SENTINEL
    rows = np.where(rng.random(m) < (0.0 if kind == "none" else 0.5), -1,
                    4).astype(np.int32)
    valid = rng.random(m) < 0.9
    args = [torch.from_numpy(a).to(cuda_device) for a in (keys, rows, valid)]
    for miss_buf in (1, 1000, 1 << 17):
        got_keys, got_missing = miss.miss_keys(*args, miss_buf)
        want_keys, want_missing = miss.miss_keys_plain(*args, miss_buf)
        assert torch.equal(got_keys, want_keys), miss_buf
        assert torch.equal(got_missing, want_missing), miss_buf


def _stream_pool(kernel, device):
    """The state a kernel's launches on the current stream start from."""
    from orleans_tpu_torch.kernels import _build

    stream = torch.cuda.current_stream(device).cuda_stream
    return _build._STREAM_POOLS[(kernel, device, stream)][1]


def _miss_redesign_case(kind, rng):
    """Lanes for K6's device-chosen sort paths and its pooled table."""
    if kind == "cold_tick":  # every lane missing over 10,000 games
        keys = rng.integers(0, 10_000, 1_000_000)
        rows = np.full(len(keys), -1)
    elif kind == "radix":  # 100,000 unique misses, negative and extreme
        keys = rng.permutation(1 << 22)[:100_000] - (1 << 21)
        keys[:3] = [-(2**31), -1, KEY_SENTINEL - 1]
        rows = np.full(len(keys), -1)
    elif kind == "tile_edge":  # exactly the tile path's limit, 16 tiles
        keys = rng.permutation(1 << 20)[:16_384] - 5
        rows = np.full(len(keys), -1)
    elif kind == "one_key":
        keys = np.full(7, -9)
        rows = np.full(7, -1)
    else:  # "cluster": the remote half of 10,000 games missing
        keys = rng.integers(0, 10_000, 1_000_000)
        rows = np.where(keys % 2 == 1, -1, keys)
    valid = rng.random(len(keys)) < 0.95
    return keys.astype(np.int32), rows.astype(np.int32), valid


@pytest.mark.parametrize("kind", ["cold_tick", "radix", "tile_edge",
                                  "one_key", "cluster"])
def test_miss_keys_sort_paths_and_clean_pool(cuda_device, kind):
    """K6's sort chosen on the device by the count of unique keys (tiles
    up to 16,384, the radix sort above it) against the plain version, twice
    in a row and then on other lanes: each launch leaves the pooled table
    all sentinel and its count 0."""
    from orleans_tpu_torch.kernels import miss

    rng = np.random.default_rng(len(kind))
    for round_ in range(3):
        keys, rows, valid = _miss_redesign_case(
            kind if round_ < 2 else "one_key", rng)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (keys, rows, valid)]
        for miss_buf in (1 << 17, 1000):
            got = miss.miss_keys(*args, miss_buf)
            want = miss.miss_keys_plain(*args, miss_buf)
            assert torch.equal(got[0], want[0]), (kind, miss_buf)
            assert torch.equal(got[1], want[1]), (kind, miss_buf)
        torch.cuda.synchronize()
        table, state = _stream_pool("miss_keys", args[0].device)
        assert bool((table == KEY_SENTINEL).all()) and \
            state.tolist() == [0, 0]


def test_resolve_adds_into_a_given_counter(cuda_device):
    dense = torch.tensor([0, -1, 2], dtype=torch.int32, device=cuda_device)
    keys = torch.tensor([0, 1, 2, 5], dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, dtype=torch.bool, device=cuda_device)
    total = torch.full((1, 2), 10, dtype=torch.int32, device=cuda_device)
    resolve.resolve_dense(dense, keys, valid, misses=total[0, 0])
    resolve.resolve_dense(dense, keys, valid, misses=total[0, 0])
    assert total.tolist() == [[14, 10]]


# -- K1's 4-lane groups and K3's paths ----------------------------------------

@pytest.mark.parametrize("m", [0, 1, 3, 5, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_resolve_dense_lane_edges_match_plain(cuda_device, m, offset):
    """K1 on short lane counts and on key and valid views that start off
    the 16- and 4-byte boundaries (head lanes, word-by-word groups, the
    partial last group), adding into a given ``misses``."""
    rng = np.random.default_rng(m + 7 * offset)
    dense = rng.permutation(1 << 14).astype(np.int32)
    dense[rng.random(1 << 14) < 0.2] = -1
    keys = rng.integers(-10, (1 << 14) + 10, m + offset).astype(np.int32)
    keys[rng.random(m + offset) < 0.05] = KEY_SENTINEL
    valid = rng.random(m + offset) < 0.9
    d_d = torch.from_numpy(dense).to(cuda_device)
    for k_off, v_off in ((offset, offset), (offset, 0), (0, offset)):
        keys_d = torch.from_numpy(keys).to(cuda_device)[k_off:k_off + m]
        valid_d = torch.from_numpy(valid).to(cuda_device)[v_off:v_off + m]
        if keys_d.shape != valid_d.shape:
            continue
        got_miss = torch.full((1,), 7, dtype=torch.int32, device=cuda_device)
        want_miss = got_miss.clone()
        rows, _ = resolve.resolve_dense(d_d, keys_d, valid_d, got_miss)
        want_rows, _ = resolve.resolve_dense_plain(d_d, keys_d, valid_d,
                                                   want_miss)
        torch.cuda.synchronize()
        assert torch.equal(rows, want_rows), (k_off, v_off)
        assert int(got_miss) == int(want_miss), (k_off, v_off)


def test_resolve_fresh_miss_counters_are_distinct_zeros(cuda_device):
    """Fresh miss counters come from zeroed pools: across a pool's end
    each call's count is its own, none is handed out twice, and a counter
    taken while a graph captures is zeroed by every replay."""
    dense = torch.tensor([0, -1, 2], dtype=torch.int32, device=cuda_device)
    keys = torch.tensor([0, 1, 2, 5], dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, dtype=torch.bool, device=cuda_device)
    counts = [resolve.resolve_dense(dense, keys, valid)[1]
              for _ in range(resolve.COUNTER_POOL + 5)]
    torch.cuda.synchronize()
    assert [int(c) for c in counts] == [2] * len(counts)
    assert len({c.data_ptr() for c in counts}) == len(counts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, count = resolve.resolve_dense(dense, keys, valid)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert int(count) == 2


def _scatter_forced(path, n, inner=1):
    """K3's plan forced onto ``path``: "direct" or "private" (clusters of
    8, or of 2 when ``path`` is "private2")."""
    if path == "direct":
        return segment.SegPlan(0, 0, *scatter.SCATTER_DIRECT)
    cluster = 2 if path == "private2" else 8
    chunk = -(-n * inner // cluster)
    return segment.SegPlan(cluster, -(-chunk // 4) * 4,
                               *scatter.SCATTER_PRIVATE)


def _scatter_values(rng, form, dtype, m, inner, dev):
    """The lanes' values in ``form``: "lanes" (a tensor [m, ...]), "host"
    (a host scalar) or "device" (a 0-d tensor on the card)."""
    shape = (m,) if inner == 1 else (m, inner)
    if form == "host":
        return np.int32(9) if dtype == torch.int32 else 0.75
    if form == "device":
        return torch.tensor(9 if dtype == torch.int32 else 0.75, dtype=dtype,
                            device=dev)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32) \
        if dtype == torch.int32 else rng.standard_normal(shape).astype(
            np.float32)
    return torch.from_numpy(vals).to(dev)


def _assert_scatter(got, want, op, rows, values, base, n, inner):
    if op == "add" and got.dtype == torch.float32:
        m = len(rows)
        lanes = values.cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values, np.float32)
        lanes = np.broadcast_to(lanes, (m, inner) if inner > 1 else (m,))
        for j in range(inner):
            col = lanes if inner == 1 else lanes[:, j]
            b = base if inner == 1 else base[:, j]
            tol = _fan_in_tol(col, rows, n, base=b)
            diff = (got - want).cpu().numpy().reshape(n, inner)[:, j]
            assert np.all(np.abs(diff) <= tol)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["lanes", "host", "device"])
@pytest.mark.parametrize("shape", ["hot", "sinks", "inner", "odd"])
@pytest.mark.parametrize("path", ["planned", "direct", "private",
                                  "private2"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "max"])
def test_row_scatter_paths_match_plain(cuda_device, op, dtype, path, shape,
                                       form, monkeypatch):
    """K3's ADD and MAX on each path: a hot row that whole warps hit
    among other rows, 1,024 rows fed by 1,048,576 lanes (256 live, the
    routing sample's sinks), [m, 3] lanes, and an odd lane count; each with
    its own values, a host scalar and a 0-d device scalar.  int32 values
    span the whole range, so ADD wraps."""
    rng = np.random.default_rng(11)
    n, m, inner = {"hot": (300, 50_000, 1), "sinks": (1024, 1 << 20, 1),
                   "inner": (700, 50_000, 3), "odd": (37, 1001, 1)}[shape]
    rows = _rows(rng, n, m)
    if shape == "hot":
        rows[:40_000] = 123
    if shape == "sinks":
        rows = rng.integers(0, 256, m).astype(np.int32)
    if path != "planned":
        plan = _scatter_forced(path, n, inner)
        monkeypatch.setattr(scatter, "scatter_plan", lambda *a: plan)
    values = _scatter_values(rng, form, dtype, m, inner, cuda_device)
    base = rng.integers(-1000, 1000, (n, inner) if inner > 1 else n)
    col = torch.from_numpy(base.astype(np.int32)).to(cuda_device).to(dtype)
    r_d = torch.from_numpy(rows).to(cuda_device)
    before = scatter.row_scatter.launches
    got = scatter.row_scatter(col.clone(), r_d, values, op)
    torch.cuda.synchronize()
    assert scatter.row_scatter.launches == before + 1
    want = scatter.row_scatter_plain(col.clone(), r_d, values, op)
    _assert_scatter(got, want, op, rows, values, base, n, inner)


@pytest.mark.parametrize("path", ["direct", "private"])
@pytest.mark.parametrize("op", ["set", "add", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_row_scatter_views_offset_match_plain(cuda_device, dtype, op, path,
                                              monkeypatch):
    """Rows, values and the column as views 4 B past a 16-byte boundary
    (and rows and values at different offsets): SET's scalar head and
    tail around its 16-byte groups, and its word-by-word values."""
    rng = np.random.default_rng(12)
    n, m = (2048, 40_003) if op != "set" else (1 << 16, 40_003)
    if path == "private" and op != "set":
        plan = _scatter_forced(path, n)
        monkeypatch.setattr(scatter, "scatter_plan", lambda *a: plan)
    rows = _rows(rng, n, m + 2, unique=(op == "set"))
    if op == "set":
        # distinct rows, 4,000 of them in a row (on and off 16-byte
        # boundaries of the column), 10% dropped
        run = np.arange(64, 4064, dtype=np.int32)
        perm = rng.permutation(n).astype(np.int32)
        rest = perm[~np.isin(perm, run)]
        rows = np.concatenate([rest[:100], run, rest[100:]])[:m + 2]
        rows[rng.random(m + 2) < 0.1] = -1
    vals = rng.integers(-1000, 1000, m + 2).astype(np.int32)
    base = rng.integers(-1000, 1000, n + 1).astype(np.int32)
    for r_off, v_off in ((1, 1), (1, 2), (0, 1), (2, 0)):
        r_d = torch.from_numpy(rows).to(cuda_device)[r_off:r_off + m]
        v_d = torch.from_numpy(vals).to(cuda_device).to(dtype)[
            v_off:v_off + m]
        col = torch.from_numpy(base).to(cuda_device).to(dtype)[1:]
        got = scatter.row_scatter(col.clone(), r_d, v_d, op)
        want = scatter.row_scatter_plain(col.clone(), r_d, v_d, op)
        torch.cuda.synchronize()
        _assert_scatter(got, want, op, rows[r_off:r_off + m],
                        vals[v_off:v_off + m].astype(np.float32), base[1:],
                        n, 1)


@pytest.mark.parametrize("path", ["direct", "private"])
def test_row_scatter_max_propagates_nan(cuda_device, path, monkeypatch):
    """float32 MAX: a NaN lane makes its row NaN on both paths, a row
    already NaN stays NaN, -inf and -0.0 order as the plain version's."""
    rng = np.random.default_rng(13)
    n, m = 512, 60_000
    plan = _scatter_forced(path, n)
    monkeypatch.setattr(scatter, "scatter_plan", lambda *a: plan)
    rows = _rows(rng, n, m)
    vals = rng.standard_normal(m).astype(np.float32)
    vals[rng.random(m) < 0.0005] = np.nan
    vals[rng.random(m) < 0.01] = -np.inf
    base = rng.standard_normal(n).astype(np.float32)
    base[::50] = np.nan
    base[1::50] = -np.inf
    col = torch.from_numpy(base).to(cuda_device)
    r_d = torch.from_numpy(rows).to(cuda_device)
    v_d = torch.from_numpy(vals).to(cuda_device)
    got = scatter.row_scatter(col.clone(), r_d, v_d, "max").cpu().numpy()
    want = scatter.row_scatter_plain(col.clone(), r_d, v_d,
                                     "max").cpu().numpy()
    assert np.isnan(got).sum() > np.isnan(base).sum()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("path", ["direct", "private"])
def test_row_scatter_int32_add_wraps(cuda_device, path, monkeypatch):
    """int32 ADD wraps around 2**31 on both paths, as the plain version's
    does."""
    n, m = 64, 100_000
    plan = _scatter_forced(path, n)
    monkeypatch.setattr(scatter, "scatter_plan", lambda *a: plan)
    rows = (np.arange(m) % n).astype(np.int32)
    col = torch.full((n,), 2**31 - 5, dtype=torch.int32, device=cuda_device)
    r_d = torch.from_numpy(rows).to(cuda_device)
    vals = torch.full((m,), 2**30 + 3, dtype=torch.int32, device=cuda_device)
    got = scatter.row_scatter(col.clone(), r_d, vals, "add")
    want = scatter.row_scatter_plain(col.clone(), r_d, vals, "add")
    assert torch.equal(got, want)
    lanes = int(np.bincount(rows)[0])
    expect = (np.int64(2**31 - 5) + lanes * np.int64(2**30 + 3)) % 2**32
    assert int(got[0]) == int(np.int64(expect).astype(np.uint32).astype(
        np.int32))


@pytest.mark.parametrize("shape", ["sinks", "hot", "players"])
def test_row_scatter_touch_replays_a_new_tick(cuda_device, shape):
    """The touch (MAX of a 0-d device tick) captured into a CUDA graph on
    the path ``scatter_plan`` chose, replayed after the tick changes:
    each replay stamps the new tick, never the captured one, and a lower
    tick leaves the column as it was."""
    from orleans_tpu_torch.kernels import _build

    rng = np.random.default_rng(14)
    n, m = {"sinks": (1024, 1 << 20), "hot": (1024, 1 << 20),
            "players": (1 << 21, 1 << 20)}[shape]
    rows = rng.integers(0, 256, m).astype(np.int32) if shape == "sinks" \
        else np.full(m, 3, np.int32) if shape == "hot" \
        else np.arange(m, dtype=np.int32)
    r_d = torch.from_numpy(rows).to(cuda_device)
    col = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    tick = torch.zeros((), dtype=torch.int32, device=cuda_device)
    scatter.row_scatter(col, r_d, tick, "max")  # load the module first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scatter.row_scatter(col, r_d, tick, "max")
    want = torch.zeros_like(col)
    for t in (5, 11, 4):
        tick.fill_(t)
        graph.replay()
        _build.note_replay({"row_scatter": 1})
        scatter.row_scatter_plain(want, r_d, t, "max")
        torch.cuda.synchronize()
        assert torch.equal(col, want), t
    assert int(col.max()) == 11


# -- CUDA graphs over the ctypes-launched kernels ------------------------------

def test_graph_replays_a_ctypes_kernel(cuda_device):
    """K3 launched through ctypes on torch's capture stream is captured,
    replays with the tick copied into its input buffer, and the launch
    counters tell captured launches from replayed ones."""
    from orleans_tpu_torch.kernels import _build

    col = torch.zeros(1000, dtype=torch.int32, device=cuda_device)
    rows = torch.arange(0, 1000, 2, dtype=torch.int32, device=cuda_device)
    tick = torch.zeros((), dtype=torch.int32, device=cuda_device)
    scatter.row_scatter(col, rows, tick, "set")  # load the module first
    torch.cuda.synchronize()
    before = dict(_build.launch_report()["row_scatter"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scatter.row_scatter(col, rows, tick, "set")
    after = _build.launch_report()["row_scatter"]
    assert after["captured"] == before["captured"] + 1
    assert after["eager"] == before["eager"]
    for t in (3, 9):
        tick.fill_(t)
        graph.replay()
        _build.note_replay({"row_scatter": 1})
        torch.cuda.synchronize()
        assert int(col[0]) == t and int(col[1]) == 0 and int(col[998]) == t
    assert _build.launch_report()["row_scatter"]["replayed"] \
        == before["replayed"] + 2


# -- the fused window on the card against the CPU -----------------------------

def _presence_autofused(device):
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples.presence import run_presence_load
    from orleans_tpu_torch.tensor.engine import TensorEngine

    engine = TensorEngine(device=device, config=TensorEngineConfig(
        auto_fusion_ticks=3, auto_fusion_window=4))
    stats = asyncio.run(run_presence_load(engine, n_players=2000,
                                          n_games=20, n_ticks=16))
    return engine, stats


def test_fused_window_on_card_matches_cpu(cuda_device):
    """Auto-fused Presence: the card's graph replays give the CPU's eager
    windows' arenas, counters and ledger histogram."""
    from orleans_tpu_torch.kernels import _build

    gpu, gstats = _presence_autofused(cuda_device)
    cpu, cstats = _presence_autofused("cpu")
    assert gstats["autofuse"] == cstats["autofuse"]
    assert gstats["autofuse"]["windows_run"] > 0
    assert gpu.messages_processed == cpu.messages_processed
    prog = gpu.autofuser._program or next(iter(
        gpu.autofuser._programs.values()))
    assert prog.replays == gstats["autofuse"]["windows_run"]
    assert _build.launch_report()["hist_count"]["replayed"] > 0
    _assert_presence_arenas_match(gpu, cpu)
    assert gpu.ledger.snapshot() == cpu.ledger.snapshot()
    # the attribution plane, folded inside the graph windows (K7) and by
    # the unfused ticks (K7/K8), snapshotted by K9
    assert _build.launch_report()["attr_fold"]["replayed"] > 0
    _assert_attribution_matches(gpu, cpu)


def _assert_attribution_matches(gpu, cpu):
    """Per-key totals exactly; snapshots equal but for the Gini gauge,
    which K9 sums in float64 in another order than the plain version
    (relative 2**-20)."""
    for name in ("PresenceGrain", "GameGrain"):
        assert gpu.attribution.per_key_totals(name) == \
            cpu.attribution.per_key_totals(name), name
    gs, cs = gpu.attribution.snapshot(), cpu.attribution.snapshot()
    for snap in (gs, cs):
        for a in snap["arenas"].values():
            a["skew"]["gini"] = round(a["skew"]["gini"], 5)
    assert gs == cs


def _assert_presence_arenas_match(gpu, cpu):
    """Both Presence arenas by key: integers exactly, the float fan-in
    within twice Higham's bound."""
    for name in ("PresenceGrain", "GameGrain"):
        ga, ca = gpu.arena_for(name), cpu.arena_for(name)
        keys = np.sort(ca.keys())
        np.testing.assert_array_equal(keys, np.sort(ga.keys()))
        grows, crows = ga.lookup_rows(keys)[0], ca.lookup_rows(keys)[0]
        for col in ca.state:
            got = ga.state[col].cpu().numpy()[grows]
            want = ca.state[col].numpy()[crows]
            if want.dtype.kind == "f":
                k = ca.state["updates"].numpy()[crows]
                tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * np.abs(want)
                assert np.all(np.abs(got - want) <= tol), col
            else:
                np.testing.assert_array_equal(got, want, err_msg=col)


def test_fused_payload_refreshed_in_place_on_card(cuda_device):
    """A loader that keeps one ``game`` tensor and rewrites it in place
    mid-window (every player moves at tick 9): the graph windows read the
    engage-time copy of the static leaf, the rewrite breaks the pattern,
    and the arenas equal the unfused run on the CPU."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.engine import TensorEngine

    players, games, scores = presence_inputs(2000, 20, 0)
    moved = (games + 1) % 20

    async def drive(engine):
        dev = engine.device
        # every game warm: no miss-check redeliveries in either run
        engine.arena_for("GameGrain").resolve_rows(
            np.arange(20, dtype=np.int64))
        injector = engine.make_injector("PresenceGrain", "heartbeat",
                                        players)
        game_buf = torch.tensor(games, device=dev)  # a copy: rewritten
        score = torch.from_numpy(scores).to(dev)
        for t in range(24):
            if t == 9:
                game_buf.copy_(torch.from_numpy(moved))
            injector.inject({"game": game_buf, "score": score,
                             "tick": np.int32(t + 1)})
            await engine.drain_queues()
        await engine.flush()
        engine.wait_completion()

    gpu = TensorEngine(device=cuda_device, config=TensorEngineConfig(
        auto_fusion_ticks=3, auto_fusion_window=4))
    cpu = TensorEngine(device="cpu", config=TensorEngineConfig(
        auto_fusion_ticks=0))
    asyncio.run(drive(gpu))
    asyncio.run(drive(cpu))
    assert gpu.autofuser.windows_run > 0
    assert gpu.messages_processed == cpu.messages_processed
    _assert_presence_arenas_match(gpu, cpu)


def test_fused_window_rebuilds_after_growth_on_card(cuda_device):
    """An arena growth between windows recaptures the graph against the
    new columns (graphs bake addresses)."""
    import orleans_tpu_torch.samples.presence  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine

    engine = TensorEngine(device=cuda_device, initial_capacity=64)
    players = np.arange(32, dtype=np.int64)
    engine.arena_for("PresenceGrain").resolve_rows(players)
    engine.arena_for("GameGrain").resolve_rows(np.arange(4, dtype=np.int64))
    prog = engine.fuse_ticks("PresenceGrain", "heartbeat", players)
    static = {"game": torch.zeros(32, dtype=torch.int32, device=cuda_device),
              "score": torch.ones(32, device=cuda_device)}
    prog.run({"tick": torch.arange(1, 3, dtype=torch.int32)}, static)
    assert prog.verify() == 0
    engine.arena_for("PresenceGrain").resolve_rows(
        np.arange(100, 400, dtype=np.int64))
    prog.run({"tick": torch.arange(3, 5, dtype=torch.int32)}, static)
    assert prog.verify() == 0
    assert prog.rebuilds["generation_repack"] == 1 and prog.replays == 2
    arena = engine.arena_for("PresenceGrain")
    rows = arena.resolve_rows(players)
    assert (arena.state["heartbeats"].cpu().numpy()[rows] == 4).all()
    assert (arena.state["last_heartbeat"].cpu().numpy()[rows] == 4).all()
    game = engine.arena_for("GameGrain")
    assert int(game.read_row(0)["updates"]) == 4 * 32


# -- the workload-attribution kernels (K7, K8, K9) ---------------------------

_SEEDS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def _attr_inputs(rng, dev, cap=N_ROWS, m=M, width=1024):
    rows = _rows(rng, cap, m)
    rows[rng.random(m) < 0.02] = -2**31
    return (torch.from_numpy(rng.integers(0, 9, cap).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 9, (4, width)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 9, 64).astype(np.int32)).to(dev),
            torch.from_numpy(rows).to(dev),
            torch.from_numpy(rng.random(m) < 0.9).to(dev))


@pytest.mark.parametrize("mode", ["full", "counts_only", "weighted",
                                  "plan", "gate_open", "gate_shut"])
def test_attr_fold_matches_plain(cuda_device, mode):
    from orleans_tpu_torch.kernels import attr

    counts, cms, slots, rows, valid = _attr_inputs(
        np.random.default_rng(40), cuda_device)
    gate = stale = None
    if mode.startswith("gate"):
        gate = torch.tensor([int(mode == "gate_open")], dtype=torch.int32,
                            device=cuda_device)
        stale = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    if mode == "plan":
        counts, cms = torch.zeros_like(counts), torch.zeros_like(cms)
        slots = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    if mode == "weighted":
        weight = torch.randint(0, 5, counts.shape, dtype=torch.int32,
                               device=cuda_device)
        kw = dict(weight=weight)
        args = (counts, cms, _SEEDS)
    else:
        kw = dict(total=slots, slot=0 if mode == "plan" else 7, gate=gate,
                  stale=stale)
        args = (counts, None if mode == "counts_only" else cms, _SEEDS,
                rows, valid)
    outs = []
    for fn in (attr.attr_fold, attr.attr_fold_plain):
        copies = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
        kwc = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        fn(*copies, **kwc)
        outs.append([c for c in copies if isinstance(c, torch.Tensor)]
                    + [v for v in kwc.values() if isinstance(v, torch.Tensor)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_attr_fold_gated_in_a_graph(cuda_device):
    """K7 gated on a device flag, captured once: each replay folds only
    while the flag is set, and bumps ``stale`` then."""
    from orleans_tpu_torch.kernels import attr

    counts = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    cms = torch.zeros((4, 16), dtype=torch.int32, device=cuda_device)
    total = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    rows = torch.arange(8, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(8, dtype=torch.bool, device=cuda_device)
    gate = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    stale = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    attr.attr_fold(counts, cms, _SEEDS, rows, valid, total=total, slot=1,
                   gate=gate, stale=stale)  # load the module first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        attr.attr_fold(counts, cms, _SEEDS, rows, valid, total=total,
                       slot=1, gate=gate, stale=stale)
    for flag in (0, 1, 0, 1, 1):
        gate.fill_(flag)
        graph.replay()
    torch.cuda.synchronize()
    assert counts[:8].tolist() == [3] * 8 and int(counts.sum()) == 24
    assert total.tolist() == [0, 24] and int(stale[0]) == 3
    assert cms.sum(dim=1).tolist() == [24] * 4


def _fold_case(rng, dev, path, mode, cap, width):
    """Accumulators and lanes for one K7 call whose shapes give ``path``:
    "cluster" puts 16 lanes (weighted: rows) on each counts row and
    sketch bucket, "direct" one lane on every 16 rows (weighted: fewer
    than 8 rows on each bucket)."""
    if mode == "weighted":
        width = max(1, cap // 16) if path == "cluster" else 2 * cap
        width = 1 << (width.bit_length() - 1)
        counts, cms, _, _, _ = _attr_inputs(rng, dev, cap, 8, width)
        return (counts, cms, _SEEDS), dict(weight=torch.from_numpy(
            rng.integers(-3, 5, cap).astype(np.int32)).to(dev))
    m = 16 * max(cap, width) if path == "cluster" else max(cap // 16, 8)
    counts, cms, slots, rows, valid = _attr_inputs(rng, dev, cap, m, width)
    gate = stale = None
    if mode.startswith("gate"):
        gate = torch.tensor([int(mode == "gate_open")], dtype=torch.int32,
                            device=dev)
        stale = torch.tensor([3], dtype=torch.int32, device=dev)
    return ((counts, None if mode == "counts_only" else cms, _SEEDS, rows,
             valid), dict(total=slots, slot=5, gate=gate, stale=stale))


@pytest.mark.parametrize("mode", ["full", "counts_only", "weighted",
                                  "gate_open", "gate_shut"])
@pytest.mark.parametrize("cap,width", [(1001, 16), (4096, 1024),
                                       (32768, 8192)])
@pytest.mark.parametrize("path", ["direct", "cluster"])
def test_attr_fold_paths_match_plain(cuda_device, path, cap, width, mode):
    """K7 on both sides of ``fold_plan``'s threshold, in each mode, with a
    cap that is not a multiple of the cluster size and a sketch of width
    16; the lanes hold rows out of range and -2**31."""
    from orleans_tpu_torch.kernels import attr

    rng = np.random.default_rng(cap + len(mode))
    args, kw = _fold_case(rng, cuda_device, path, mode, cap, width)
    weighted = "weight" in kw
    m = (kw["weight"] if weighted else args[3]).shape[0]
    depth, w = (0, 1) if args[1] is None else args[1].shape
    assert (attr.fold_plan(m, cap, depth, w, weighted).cluster > 0) \
        == (path == "cluster")
    outs = []
    for fn in (attr.attr_fold, attr.attr_fold_plain):
        a = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
        k = {n: v.clone() if isinstance(v, torch.Tensor) else v
             for n, v in kw.items()}
        fn(*a, **k)
        outs.append([x for x in a + list(k.values())
                     if isinstance(x, torch.Tensor)])
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_attr_fold_no_lanes(cuda_device, weighted):
    """m = 0: nothing folds, the gate's stale count still moves."""
    from orleans_tpu_torch.kernels import attr

    dev = cuda_device
    counts = torch.zeros(0 if weighted else 64, dtype=torch.int32,
                         device=dev)
    cms = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    total = torch.full((2,), 4, dtype=torch.int32, device=dev)
    gate = torch.ones(1, dtype=torch.int32, device=dev)
    stale = torch.zeros(1, dtype=torch.int32, device=dev)
    if weighted:
        attr.attr_fold(counts, cms, _SEEDS, total=total, slot=1,
                       weight=torch.zeros(0, dtype=torch.int32, device=dev),
                       gate=gate, stale=stale)
    else:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        attr.attr_fold(counts, cms, _SEEDS, empty, empty.bool(), total=total,
                       slot=1, gate=gate, stale=stale)
    torch.cuda.synchronize()
    assert int(counts.sum()) == 0 and int(cms.sum()) == 0
    assert total.tolist() == [4, 4] and int(stale[0]) == 1


def test_attr_fold_cluster_path_gated_in_a_graph(cuda_device):
    """K7's cluster path (GameGrain's counts column and a 4x8192 sketch)
    gated on a device flag and captured once: a shut gate leaves every
    block of every cluster before its first cluster barrier, an open one
    folds."""
    from orleans_tpu_torch.kernels import attr

    dev = cuda_device
    rng = np.random.default_rng(44)
    cap, width, m = 32768, 8192, 1 << 19
    assert attr.fold_plan(m, cap, 4, width, False).cluster > 0
    rows = torch.from_numpy(rng.integers(-5, cap + 5, m).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    cms = torch.zeros((4, width), dtype=torch.int32, device=dev)
    total = torch.zeros(2, dtype=torch.int32, device=dev)
    gate = torch.zeros(1, dtype=torch.int32, device=dev)
    stale = torch.zeros(1, dtype=torch.int32, device=dev)
    attr.attr_fold(counts, cms, _SEEDS, rows, valid, total=total, slot=1,
                   gate=gate, stale=stale)  # load the module first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        attr.attr_fold(counts, cms, _SEEDS, rows, valid, total=total,
                       slot=1, gate=gate, stale=stale)
    for flag in (0, 1, 0, 1, 1):
        gate.fill_(flag)
        graph.replay()
    torch.cuda.synchronize()
    want_c = torch.zeros_like(counts)
    want_s = torch.zeros_like(cms)
    want_t = torch.zeros_like(total)
    for _ in range(3):
        attr.attr_fold_plain(want_c, want_s, _SEEDS, rows, valid,
                             total=want_t, slot=1)
    assert torch.equal(counts, want_c) and torch.equal(cms, want_s)
    assert torch.equal(total, want_t) and int(stale[0]) == 3


@pytest.mark.parametrize("layout", ["whole", "offset_views", "odd_lengths",
                                    "misaligned", "k_zero"])
@pytest.mark.parametrize("device_k", [False, True])
def test_attr_apply_matches_plain(cuda_device, device_k, layout):
    """K8 on the attribution inputs, on views at word offsets (a head before
    the first 16-byte group), on lengths that are no multiple of 4 (a
    tail), on an accumulator and delta that differ in their address
    modulo 16 (word by word), and with k = 0."""
    from orleans_tpu_torch.kernels import attr

    rng = np.random.default_rng(41)
    counts, cms, slots, rows, valid = _attr_inputs(rng, cuda_device)
    cdelta = torch.randint(0, 3, counts.shape, dtype=torch.int32,
                           device=cuda_device)
    sdelta = torch.randint(0, 3, cms.shape, dtype=torch.int32,
                           device=cuda_device)
    cdelta[1000:5000] = 0
    n = torch.tensor([123], dtype=torch.int32, device=cuda_device)
    kv = 0 if layout == "k_zero" else 5
    k = torch.tensor([kv], dtype=torch.int32, device=cuda_device) \
        if device_k else kv

    def view(t, off, n_words):
        """A copy of t's first ``n_words`` words ``off`` words into a
        fresh buffer (whose own start is 256-byte aligned)."""
        flat = torch.empty(n_words + 8, dtype=t.dtype, device=t.device)
        v = flat[off:off + n_words]
        v.copy_(t.reshape(-1)[:n_words])
        return v

    acc_off, delta_off, trim = {
        "whole": (0, 0, 0), "offset_views": (1, 1, 0),
        "odd_lengths": (3, 3, 3), "misaligned": (1, 2, 1),
        "k_zero": (2, 2, 1)}[layout]
    n_c, n_s = counts.numel() - trim, cms.numel() - trim
    cdelta = view(cdelta, delta_off, n_c)
    sdelta = view(sdelta, delta_off, n_s).view(1, -1)
    base_c, base_s = counts[:n_c], cms.reshape(-1)[:n_s].view(1, -1)
    a = [view(base_c, acc_off, n_c), view(base_s, acc_off, n_s).view(1, -1),
         slots.clone()]
    b = [base_c.clone(), base_s.clone(), slots.clone()]
    attr.attr_apply(a[0], cdelta, a[1], sdelta, k, total=a[2], slot=9, n=n)
    attr.attr_apply_plain(b[0], cdelta, b[1], sdelta, k, total=b[2], slot=9,
                          n=n)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_attr_match_matches_plain(cuda_device):
    from orleans_tpu_torch.kernels import attr

    rng = np.random.default_rng(42)
    _, _, _, plan_rows, plan_valid = _attr_inputs(rng, cuda_device)
    rows, valid = [], []
    for e in range(32):
        r, v = plan_rows.clone(), plan_valid.clone()
        if e % 5 == 1:
            r[rng.integers(0, M)] += 1
        if e % 7 == 2:
            v[M - 1] = ~v[M - 1]
        rows.append(r)
        valid.append(v)
    outs = []
    for fn in (attr.attr_match, attr.attr_match_plain):
        flags = torch.full((32,), 9, dtype=torch.int32, device=cuda_device)
        km = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        fn(rows, valid, plan_rows, plan_valid, flags, km)
        outs.append((flags.tolist(), int(km[0])))
    assert outs[0] == outs[1]
    assert outs[0][1] == 32 - sum(1 for e in range(32)
                                  if e % 5 == 1 or e % 7 == 2)


@pytest.mark.parametrize("k", [16, 2500, "cap"])
@pytest.mark.parametrize("kind", ["ties", "zipf", "sparse", "zero", "wide",
                                  "tied_kth", "few"])
@pytest.mark.parametrize("cap,n_shards", [(1 << 16, 1), (1 << 16, 4),
                                          (3000, 1), (1 << 21, 1)])
def test_attr_snapshot_matches_plain(cuda_device, kind, cap, n_shards, k):
    """K9's edges: every radix digit live (counts of 2^24 and above and
    negative ones), ties on the k-th value over far more than k rows,
    k above nnz, k = cap, a k that sorts its candidates with the radix
    passes (above 2048), a non-power-of-two cap and 4 shards."""
    from orleans_tpu_torch.kernels import attr

    rng = np.random.default_rng(43)
    k = cap if k == "cap" else k
    tied = np.full(cap, 5)
    tied[rng.choice(cap, 7, replace=False)] = rng.integers(6, 50, 7)
    counts = {"ties": np.full(cap, 17),
              "zipf": rng.zipf(1.3, cap) % 100000,
              "sparse": np.where(rng.random(cap) < 0.01,
                                 rng.integers(1, 9, cap), 0),
              "zero": np.zeros(cap),
              "wide": np.where(rng.random(cap) < 0.5,
                               rng.integers(-2**31, 2**31 - 1, cap),
                               rng.integers(2**24, 2**26, cap)),
              "tied_kth": tied,
              "few": np.isin(np.arange(cap), [3, 77, 1500]) * 9,
              }[kind].astype(np.int32)
    c = torch.from_numpy(counts).to(cuda_device)
    cms = torch.from_numpy(rng.integers(0, 99, (4, 8192)).astype(
        np.int32)).to(cuda_device)
    got = attr.decode_snapshot(attr.attr_snapshot(c, cms, _SEEDS, k,
                                                  n_shards).cpu().numpy(),
                               k, n_shards)
    want = attr.decode_snapshot(attr.attr_snapshot_plain(
        c, cms, _SEEDS, k, n_shards).cpu().numpy(), k, n_shards)
    for key in ("vals", "rows", "est", "shard"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("total", "nnz", "p99", "mean_nz"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["gini"], want["gini"], rtol=2.0**-20,
                               atol=2.0**-30)


def test_checked_flush_on_card_matches_cpu(cuda_device):
    """The plane's device-checked flush (K8 match + multiply-add + gated
    K7 folds) on the card against the CPU's, on batches that mostly
    differ from the plan."""
    import orleans_tpu_torch.samples.presence  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine

    rng = np.random.default_rng(44)
    batches = [rng.integers(-4, 300, 256).astype(np.int32) for _ in range(40)]
    for b in batches[::3]:
        b[:] = batches[0]
    out = []
    for dev in (cuda_device, "cpu"):
        engine = TensorEngine(device=dev)
        arena = engine.arena_for("PresenceGrain")
        arena.resolve_rows(np.arange(256, dtype=np.int64))
        att = engine.attribution
        for b in batches:
            att.record_group(arena, "PresenceGrain", "heartbeat",
                             torch.from_numpy(b).to(dev),
                             torch.ones(256, dtype=torch.bool, device=dev))
        att.flush_folds()
        out.append((att.counts_for("PresenceGrain").cpu(),
                    att.cms_for("PresenceGrain").cpu(),
                    att._slot_arr().cpu(), att._stale_arr().cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert int(out[0][3][0]) == sum(1 for b in batches[1:]
                                    if not np.array_equal(b, batches[0]))


def test_fused_rollback_attribution_on_card(cuda_device):
    """A forced rollback on the card: the graph windows' folds are undone
    by the in-place restore and the unfused replay counts each message
    once — the CPU run's attribution exactly."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples.presence import presence_inputs
    from orleans_tpu_torch.tensor.engine import TensorEngine

    players, games, scores = presence_inputs(2000, 20, 0)

    async def drive(engine):
        dev = engine.device
        engine.arena_for("GameGrain").reserve(40)
        injector = engine.make_injector("PresenceGrain", "heartbeat",
                                        players)
        score = torch.from_numpy(scores).to(dev)
        for t in range(40):
            g = games.copy()
            if t >= 28:
                g[0] = 33  # a game no one has activated
            injector.inject({"game": torch.from_numpy(g).to(dev),
                             "score": score, "tick": np.int32(t + 1)})
            await engine.drain_queues()
        await engine.flush()
        engine.wait_completion()

    cfg = dict(auto_fusion_ticks=3, auto_fusion_window=4,
               auto_fusion_verify_windows=2)
    gpu = TensorEngine(device=cuda_device, config=TensorEngineConfig(**cfg))
    cpu = TensorEngine(device="cpu", config=TensorEngineConfig(**cfg))
    asyncio.run(drive(gpu))
    asyncio.run(drive(cpu))
    assert gpu.autofuser.snapshot() == cpu.autofuser.snapshot()
    assert gpu.autofuser.windows_rolled_back == 1
    _assert_presence_arenas_match(gpu, cpu)
    _assert_attribution_matches(gpu, cpu)
    assert gpu.attribution.per_key_totals("PresenceGrain") == \
        {k: 40 for k in range(2000)}


# -- K10 resolve_wide and K11 fanout_expand -----------------------------------

def _wide_mirror(rng, n_live=3000, cap=8192):
    """A port arena's wide mirror holding colliding, edge-word and random
    keys, and a pool of query keys (live, unseen, colliding unseen)."""
    from orleans_tpu_torch.samples import presence  # noqa: F401
    from orleans_tpu_torch.tensor.arena import (
        GrainArena,
        mix32_np,
        split_wide_keys,
    )
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    draws = np.unique(rng.integers(2**31, 2**63 - 1, 300_000,
                                   dtype=np.int64))
    h = mix32_np(*split_wide_keys(draws))
    _, inv, cnt = np.unique(h, return_inverse=True, return_counts=True)
    colliding = draws[cnt[inv] > 1]
    edge = np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                     (2**31 - 1) << 32, ((2**31 - 1) << 32) | (2**32 - 1),
                     (1 << 32) | (2**31)], np.int64)
    live = np.unique(np.concatenate([colliding[::2], edge,
                                     draws[:n_live]]))
    arena = GrainArena(vector_type("PresenceGrain"), torch.device("cpu"),
                       capacity=cap)
    arena.resolve_rows(live)
    pool = np.concatenate([live, colliding[1::2],
                           rng.integers(0, 2**63 - 1, 500, dtype=np.int64)])
    return arena.device_index_wide(), pool


@pytest.mark.parametrize("mode", ["wide", "narrow_into_wide"])
def test_resolve_wide_matches_plain(cuda_device, mode):
    from orleans_tpu_torch.tensor.arena import split_wide_keys

    rng = np.random.default_rng(11)
    mirror, pool = _wide_mirror(rng)
    m = 200_000
    if mode == "wide":
        hi, lo = (torch.from_numpy(w) for w in
                  split_wide_keys(rng.choice(pool, m)))
    else:
        hi = None
        lo = torch.from_numpy(rng.choice(
            np.array([0, 5, 6, 2**31 - 1, -3], np.int64), m).astype(
            np.int32))
    valid = torch.from_numpy(rng.random(m) < 0.9)
    want = resolve.resolve_wide(*mirror, hi, lo, valid)
    dev = [t.to(cuda_device) for t in mirror]
    counter = torch.full((1, 2), 5, dtype=torch.int32, device=cuda_device)
    got = resolve.resolve_wide(
        *dev, None if hi is None else hi.to(cuda_device), lo.to(cuda_device),
        valid.to(cuda_device), misses=counter[0, 0])
    assert torch.equal(got[0].cpu(), want[0])
    assert counter.tolist() == [[5 + int(want[1]), 5]]
    assert (want[0] >= 0).any() and int(want[1]) > 0


def _fanout_case(kind, rng):
    from orleans_tpu_torch.samples.chirper import build_follow_graph
    from orleans_tpu_torch.tensor.fanout import DeviceFanout

    if kind == "empty_graph":
        return DeviceFanout(budget=64), np.array([0, 3, KEY_SENTINEL],
                                                 np.int32)
    if kind == "overflow":
        fan = DeviceFanout(budget=600)
        for d in range(300):
            fan.follow(1, 1000 + d)
        fan.follow(2, 5)
        return fan, np.array([1, 2, 1, 1, 7, 2] * 3, np.int32)
    fan = build_follow_graph(20_000, 8.0, seed=2)
    m = 1_200_000 if kind == "many_lanes" else 20_000
    # "many_lanes": more lane blocks than one block of the scan of block
    # sums holds, most lanes without edges
    hi = 20_000 if kind == "power_law" else 4_000_000
    return fan, rng.integers(0, hi, m).astype(np.int32)


@pytest.mark.parametrize("kind", ["power_law", "many_lanes", "empty_graph",
                                  "overflow"])
def test_fanout_expand_matches_plain(cuda_device, kind):
    from orleans_tpu_torch.kernels import fanout as kfan

    rng = np.random.default_rng(12)
    fan, src = _fanout_case(kind, rng)
    valid = rng.random(len(src)) < 0.95
    csr = fan.csr(torch.device("cpu"))
    want = kfan.fanout_expand(*csr, torch.from_numpy(src),
                              torch.from_numpy(valid))
    got = kfan.fanout_expand(*(t.to(cuda_device) for t in csr),
                             torch.from_numpy(src).to(cuda_device),
                             torch.from_numpy(valid).to(cuda_device))
    torch.cuda.synchronize()
    for name, g, w in zip(("dst", "src_index", "out_valid", "total",
                           "src_dropped", "n_dropped"), got, want):
        assert torch.equal(g.cpu(), w), name
    if kind == "overflow":
        assert int(want[5]) > 0


def test_fanout_expand_in_a_graph(cuda_device):
    """K11 captured into a CUDA graph with its drop count added into a
    window total: every replay re-expands the current source buffer."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.kernels import fanout as kfan
    from orleans_tpu_torch.tensor.fanout import DeviceFanout

    fan = DeviceFanout(budget=8)
    for s, ds in {1: [10, 11, 12], 2: [20, 21], 3: [30]}.items():
        for d in ds:
            fan.follow(s, d)
    csr = fan.csr(cuda_device)
    src = torch.tensor([1, 2, 3, 9], dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, dtype=torch.bool, device=cuda_device)
    total = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    kfan.fanout_expand(*csr, src, valid)  # load the module first
    torch.cuda.synchronize()
    before = dict(_build.launch_report()["fanout_expand"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kfan.fanout_expand(*csr, src, valid, n_dropped=total[0, 0])
    assert _build.launch_report()["fanout_expand"]["captured"] \
        == before["captured"] + 1
    cpu_csr = fan.csr(torch.device("cpu"))
    for keys, drops in (([1, 2, 3, 9], 0), ([1, 1, 1, 2], 2)):
        src.copy_(torch.tensor(keys, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = kfan.fanout_expand(*cpu_csr, torch.tensor(keys,
                                                         dtype=torch.int32),
                                  torch.ones(4, dtype=torch.bool))
        for g, w in zip(out[:5], want[:5]):
            assert torch.equal(g.cpu(), w)
        assert int(want[5]) == drops
    assert total.tolist() == [[2, 0]]


def _fanout_redesign_case(kind, rng):
    """(csr_keys, csr_offsets, csr_dst, src, valid) for K11's plans."""
    if kind == "wrap":  # the int32 scan wraps: the per-slot search
        keys = np.array([3, 8, 11, 20])
        offsets = np.array([0, 5, 2**30 + 5, 2**31 - 9, 2**31 - 2])
        dst = rng.integers(0, 1000, 50_000)
        src = np.array([3, 8, 8, 20, 11, 8, 3, 8, 99, 11] * 300)
    elif kind == "power_law_row":  # one source of 200,000 edges
        deg = np.concatenate([[200_000], np.minimum(rng.zipf(1.6, 20_000),
                                                    5_000)])
        keys = np.sort(rng.choice(1 << 20, len(deg), replace=False))
        offsets = np.concatenate([[0], np.cumsum(deg)])
        dst = rng.integers(0, 1 << 20, int(offsets[-1]) + 999)
        src = np.concatenate([keys[:1], rng.choice(keys, 60_000),
                              rng.integers(0, 1 << 20, 9_000)])
        rng.shuffle(src)
    elif kind == "crowded_windows":  # most lanes without edges
        keys = np.arange(0, 40_000, 2)
        offsets = np.concatenate([[0], np.cumsum(rng.integers(1, 4,
                                                              len(keys)))])
        dst = rng.integers(0, 1000, int(offsets[-1]) + 5)
        src = rng.integers(0, 40_000, 400_000)
        src[rng.random(len(src)) < 0.98] = 1  # no such source
    else:  # "unaligned_width": a width off the 4-slot groups, overflowing
        keys = np.array([1, 2, 5])
        offsets = np.array([0, 3000, 3001, 3500])
        dst = rng.integers(0, 1000, 6_003)
        src = np.array([1, 2, 1, 5, 1, 7, 2, 5] * 40)
    return (keys.astype(np.int32), offsets.astype(np.int32),
            dst.astype(np.int32), src.astype(np.int32),
            rng.random(len(src)) < 0.95)


@pytest.mark.parametrize("kind", ["wrap", "power_law_row",
                                  "crowded_windows", "unaligned_width"])
def test_fanout_expand_plans_match_plain(cuda_device, kind):
    """K11's plans against the plain version: the wrapping scan (the
    per-slot search chosen on the device), one source of 200,000 edges,
    slot tiles whose owners spread over several windows, a width off the
    16-byte groups; twice each, and the pooled look-back state is zero
    after every launch."""
    from orleans_tpu_torch.kernels import fanout as kfan

    rng = np.random.default_rng(len(kind))
    cpu = [torch.from_numpy(a) for a in _fanout_redesign_case(kind, rng)]
    want = kfan.fanout_expand_plain(*cpu)
    for _ in range(2):
        got = kfan.fanout_expand(*(t.to(cuda_device) for t in cpu))
        torch.cuda.synchronize()
        for name, g, w in zip(("dst", "src_index", "out_valid", "total",
                               "src_dropped", "n_dropped"), got, want):
            assert torch.equal(g.cpu(), w), (kind, name)
        words = _stream_pool("fanout_expand", got[0].device)
        assert int(words.abs().sum()) == 0


def test_fanout_expand_replays_twice_with_a_clean_look_back(cuda_device):
    """K11 captured into a CUDA graph at a shape of many lane tiles (the
    look-back walks over several windows of 32): two replays on new source
    lanes each equal the plain version, and an eager launch between and
    after them still does (the graph's look-back words are its own)."""
    from orleans_tpu_torch.kernels import fanout as kfan
    from orleans_tpu_torch.samples.chirper import build_follow_graph

    rng = np.random.default_rng(21)
    fan = build_follow_graph(50_000, 10.0, seed=3)
    csr = fan.csr(cuda_device)
    cpu_csr = fan.csr(torch.device("cpu"))
    m = 80_000
    src = torch.zeros(m, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(m, dtype=torch.bool, device=cuda_device)
    kfan.fanout_expand(*csr, src, valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kfan.fanout_expand(*csr, src, valid)
    for _ in range(2):
        keys = rng.integers(0, 52_000, m).astype(np.int32)
        src.copy_(torch.from_numpy(keys))
        graph.replay()
        eager = kfan.fanout_expand(*csr, src, valid)
        torch.cuda.synchronize()
        want = kfan.fanout_expand_plain(*cpu_csr, torch.from_numpy(keys),
                                        torch.ones(m, dtype=torch.bool))
        for g, e, w in zip(out[:5], eager[:5], want[:5]):
            assert torch.equal(g.cpu(), w) and torch.equal(e.cpu(), w)


def _chirper_autofused(device, fan, follow_after=None):
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples.chirper import run_chirper_load
    from orleans_tpu_torch.tensor.engine import TensorEngine

    engine = TensorEngine(device=device, config=TensorEngineConfig(
        auto_fusion_ticks=3, auto_fusion_window=4))
    stats = asyncio.run(run_chirper_load(engine, n_accounts=3000,
                                         n_ticks=16, fanout=fan))
    if follow_after is not None:
        fan.follow(*follow_after)
        stats = asyncio.run(run_chirper_load(engine, n_accounts=3000,
                                             n_ticks=16, fanout=fan))
    return engine, stats


def test_fused_chirper_window_on_card_matches_cpu(cuda_device):
    """Auto-fused Chirper, the follower expansion inside the graph windows
    (K11 replayed), then a follow() and more windows (the window rebuilds
    on the new graph): the card equals the CPU."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.chirper import build_follow_graph

    gpu, gstats = _chirper_autofused(cuda_device,
                                     build_follow_graph(3000, 6.0, seed=4),
                                     follow_after=(5, 7))
    cpu, cstats = _chirper_autofused("cpu",
                                     build_follow_graph(3000, 6.0, seed=4),
                                     follow_after=(5, 7))
    assert gstats["autofuse"] == cstats["autofuse"]
    assert gstats["autofuse"]["ticks_fused"] > 0
    assert _build.launch_report()["fanout_expand"]["replayed"] > 0
    assert gpu.messages_processed == cpu.messages_processed
    ga, ca = gpu.arena_for("ChirperAccount"), cpu.arena_for("ChirperAccount")
    keys = np.sort(ca.keys())
    grows, crows = ga.lookup_rows(keys)[0], ca.lookup_rows(keys)[0]
    for col in ca.state:
        got = ga.state[col].cpu().numpy()[grows]
        want = ca.state[col].numpy()[crows]
        if want.dtype.kind == "f":
            k = ca.state["received"].numpy()[crows]
            tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * np.abs(want)
            assert np.all(np.abs(got - want) <= tol), col
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)
    assert gpu.ledger.snapshot() == cpu.ledger.snapshot()
    prog = next(iter(gpu.autofuser._programs.values()))
    assert prog.rebuilds["fanout_rebuild"] >= 1


def test_wide_presence_window_on_card_matches_cpu(cuda_device):
    """A fused WidePresence window on the card (K10 replayed in the graph)
    equals the CPU run."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import presence_wide
    from orleans_tpu_torch.tensor.engine import TensorEngine

    players, games, _idx, words, scores = \
        presence_wide.wide_presence_inputs(5000, 50, seed=1)
    out = {}
    for device in (cuda_device, "cpu"):
        eng = TensorEngine(device=device)
        eng.arena_for("WideGame").resolve_rows(games)
        prog = eng.fuse_ticks("WidePresence", "heartbeat", players)
        static = {"game_hi": torch.from_numpy(words[0]).to(device),
                  "game_lo": torch.from_numpy(words[1]).to(device),
                  "score": torch.from_numpy(scores).to(device)}
        for w in range(3):
            prog.run({"tick": torch.arange(4 * w, 4 * w + 4,
                                           dtype=torch.int32)}, static)
        assert prog.verify() == 0
        ga = eng.arena_for("WideGame")
        rows, _ = ga.lookup_rows(games)
        out[str(device)] = {c: v.cpu().numpy()[rows]
                            for c, v in ga.state.items()}
    assert _build.launch_report()["resolve_wide"]["replayed"] > 0
    g, c = out[str(cuda_device)], out["cpu"]
    np.testing.assert_array_equal(g["updates"], c["updates"])
    tol = 2 * np.maximum(c["updates"] - 1, 0) * 2.0**-24 \
        * np.abs(c["total_score"])
    assert np.all(np.abs(g["total_score"] - c["total_score"]) <= tol)


# -- the grain lifecycle and the timers plane (K12–K15) -----------------------

@pytest.mark.parametrize("cutoff", [-2**31 + 1, 0, 37, 2**31 - 1])
def test_idle_mask_matches_plain(cuda_device, cutoff):
    from orleans_tpu_torch.kernels import lifecycle

    rng = np.random.default_rng(12)
    n = 100_003
    clocks = [rng.integers(0, 80, n).astype(np.int32) for _ in range(2)]
    clocks[1][::7] = 2**31 - 1
    args = [torch.from_numpy(c).to(cuda_device) for c in clocks] + [
        torch.from_numpy(rng.random(n) < 0.6).to(cuda_device)]
    got = lifecycle.idle_mask(*args, cutoff)
    assert torch.equal(got, lifecycle.idle_mask_plain(*args, cutoff))


@pytest.mark.parametrize("dtype,width", [(torch.int32, ()),
                                         (torch.float32, ()),
                                         (torch.float32, (3,))])
def test_gather_rows_matches_plain(cuda_device, dtype, width):
    from orleans_tpu_torch.kernels import lifecycle

    rng = np.random.default_rng(13)
    col = torch.from_numpy(rng.standard_normal((N_ROWS, *width)) * 1e4).to(
        dtype).to(cuda_device)
    rows = rng.integers(0, N_ROWS, 5000).astype(np.int32)
    rows[:5] = [-1, -7, N_ROWS, N_ROWS + 3, KEY_SENTINEL]
    r = torch.from_numpy(rows).to(cuda_device)
    assert torch.equal(lifecycle.gather_rows(col, r),
                       lifecycle.gather_rows_plain(col, r))


def test_timers_write_matches_plain(cuda_device):
    from orleans_tpu_torch.kernels import timers

    rng = np.random.default_rng(14)
    n, w = 4097, 2048

    def cols():
        return [torch.from_numpy(rng_cols[i].copy()).to(cuda_device)
                for i in range(4)]

    rng_cols = [rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
                .astype(np.int32) for _ in range(4)]
    idx = np.zeros(w, np.int32)
    idx[:1500] = rng.choice(np.arange(1, n), 1500, replace=False)
    idx[7] = n + 5  # dropped
    vals = [np.full(w, KEY_SENTINEL, np.int32)] + [np.zeros(w, np.int32)] * 3
    vals = [v.copy() for v in vals]
    for v in vals:
        v[:1500] = rng.integers(0, 2**31 - 1, 1500)
    a, b = cols(), cols()
    args = [torch.from_numpy(x).to(cuda_device) for x in [idx] + vals]
    timers.timers_write(*a, *args)
    timers.timers_write_plain(*b, *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("now", [0, 9, 2**31 - 1, -2**31 + 10])
@pytest.mark.parametrize("kind", ["random", "edges", "empty"])
def test_timers_harvest_matches_plain(cuda_device, kind, now):
    from orleans_tpu_torch.kernels import timers

    rng = np.random.default_rng(15)
    n = 4096
    key = rng.integers(0, 1 << 20, n).astype(np.int32)
    key[0] = KEY_SENTINEL
    key[rng.random(n) < 0.2] = KEY_SENTINEL
    if kind == "edges":
        due = np.resize(np.array([0, -2**31 + 1, 2**31 - 1, -5, 2**31 - 4,
                                  -2**30, 7], np.int64), n).astype(np.int32)
        period = np.resize(np.array([0, 1, 2**31 - 1, 3, 2**30 + 5, 7, 2],
                                    np.int64), n).astype(np.int32)
    else:
        due = rng.integers(-50, 50, n).astype(np.int32)
        period = np.where(rng.random(n) < 0.5, 0,
                          rng.integers(1, 9, n)).astype(np.int32)
    name = rng.integers(0, 4, n).astype(np.int32)
    w = 0 if kind == "empty" else 2048
    idx = np.zeros(w, np.int32)
    idx[:w * 3 // 4] = rng.choice(np.arange(1, n), w * 3 // 4,
                                  replace=False)
    d = cuda_device
    ro = [torch.from_numpy(period).to(d), torch.from_numpy(name).to(d)]
    a = [torch.from_numpy(key).to(d), torch.from_numpy(due).to(d)]
    b = [x.clone() for x in a]
    i = torch.from_numpy(idx).to(d)
    got = timers.timers_harvest(*a, *ro, i, now)
    want = timers.timers_harvest_plain(*b, *ro, i, now)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _watchdog_fused_with_eviction(device):
    """FleetDeviceGrain heartbeating every tick on half the fleet (fused
    into graph windows on the card), a periodic watch on every device,
    and an eviction of the silent half between windows; the next watch
    re-activates them through the store."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import watchdog  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

    n = 4096
    engine = TensorEngine(device=device, store=MemoryVectorStore(),
                          config=TensorEngineConfig(auto_fusion_ticks=4,
                                                    auto_fusion_window=4))
    keys = np.arange(n, dtype=np.int64)
    every = engine.make_injector("FleetDeviceGrain", "heartbeat", keys)
    every.inject({})
    engine.run_tick()
    engine.timers.arm_batch("FleetDeviceGrain", keys,
                            np.full(n, engine.tick_number + 6), 6, "watch")
    hot = engine.make_injector("FleetDeviceGrain", "heartbeat",
                               keys[:n // 2])

    async def beats(ticks):
        for _ in range(ticks):
            hot.inject({"beat": np.ones(n // 2, np.int32)})
            engine.run_tick()
        await engine.flush()

    asyncio.run(beats(20))
    evicted = engine.arena_for("FleetDeviceGrain").evict_keys(keys[n // 2:])
    asyncio.run(beats(20))

    async def quiet(ticks):
        # ticks with no injection run unfused: the starved watches fire
        for _ in range(ticks):
            engine.run_tick()
        await engine.flush()

    asyncio.run(quiet(8))
    return engine, evicted


def test_eviction_and_harvest_between_graph_windows_on_card(cuda_device):
    from orleans_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    gpu, g_evicted = _watchdog_fused_with_eviction(cuda_device)
    report = _build.launch_report()
    cpu, c_evicted = _watchdog_fused_with_eviction("cpu")
    assert g_evicted == c_evicted > 0
    assert gpu.stats()["restored"] == g_evicted
    assert gpu.autofuser.snapshot() == cpu.autofuser.snapshot()
    assert gpu.autofuser.snapshot()["windows_run"] > 0
    for k in ("ticks", "messages", "evicted", "restored"):
        assert gpu.stats()[k] == cpu.stats()[k], k
    gs, cs = gpu.timers.snapshot(), cpu.timers.snapshot()
    gs.pop("harvest_seconds")
    cs.pop("harvest_seconds")
    assert gs == cs
    ga, ca = gpu.arena_for("FleetDeviceGrain"), cpu.arena_for(
        "FleetDeviceGrain")
    np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
    for name in ca.state:
        np.testing.assert_array_equal(ga.state[name].cpu().numpy(),
                                      ca.state[name].numpy(), err_msg=name)
    # evict_keys selects no idle rows (K12 is the sweep's): the gather
    # of the write-back, the arm and the harvests launched
    for name in ("gather_rows", "timers_write", "timers_harvest"):
        assert report[name]["eager"] > 0, name
    assert report["row_scatter"]["replayed"] > 0


def _presence_collection(device):
    """A Presence slice with collection on (tests/test_torch_lifecycle.py
    holds the CPU engine against JAX's): all players activate, a hot
    tenth keeps beating, the collector evicts the rest with write-back,
    an evicted player re-activates through the store."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import presence  # noqa: F401
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.persistence import MemoryVectorStore

    n, hot = 6000, 600
    store = MemoryVectorStore()
    engine = TensorEngine(device=device, store=store,
                          config=TensorEngineConfig(
                              auto_fusion_ticks=0, collection_idle_ticks=24,
                              collection_every_ticks=8,
                              collection_pause_budget_s=1e-9,
                              collection_chunk_rows=512))
    keys = np.arange(n, dtype=np.int64)
    games = (keys % 60).astype(np.int32)

    def payload(ks, tick):
        return {"game": games[:len(ks)], "score": np.ones(len(ks),
                                                          np.float32),
                "tick": np.full(len(ks), tick, np.int32)}

    async def go():
        inj = engine.make_injector("PresenceGrain", "heartbeat", keys)
        for _ in range(4):
            inj.inject(payload(keys, engine.tick_number))
            engine.run_tick()
        await engine.flush()
        hot_inj = engine.make_injector("PresenceGrain", "heartbeat",
                                       keys[:hot])
        for _ in range(60):
            hot_inj.inject(payload(keys[:hot], engine.tick_number))
            engine.run_tick()
        await engine.flush()
        engine.send_batch("PresenceGrain", "heartbeat",
                          np.array([n - 1], dtype=np.int64),
                          payload(keys[:1], 0))
        await engine.flush()

    asyncio.run(go())
    return engine, store


def test_collection_slice_on_card_matches_cpu(cuda_device):
    gpu, gstore = _presence_collection(cuda_device)
    cpu, cstore = _presence_collection("cpu")
    arena = gpu.arena_for("PresenceGrain")
    assert arena.evicted_count == cpu.arena_for("PresenceGrain") \
        .evicted_count == 5400
    assert arena.restored_count == 1
    for name in ("PresenceGrain", "GameGrain"):
        ga, ca = gpu.arena_for(name), cpu.arena_for(name)
        np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
        np.testing.assert_array_equal(ga._free[0], ca._free[0])
        for col in ca.state:
            np.testing.assert_array_equal(ga.state[col].cpu().numpy(),
                                          ca.state[col].numpy(), err_msg=col)
        assert gpu.attribution.per_key_totals(name) == \
            cpu.attribution.per_key_totals(name), name
    keys = cstore.list_keys("PresenceGrain")
    np.testing.assert_array_equal(gstore.list_keys("PresenceGrain"), keys)
    gr = gstore.read_many("PresenceGrain", keys.tolist())
    cr = cstore.read_many("PresenceGrain", keys.tolist())
    for k in keys.tolist():
        for f, v in cr[k].items():
            np.testing.assert_array_equal(gr[k][f], v)
    gc, cc = gpu.collector.snapshot(), cpu.collector.snapshot()
    for k in ("sweeps_started", "sweeps_completed", "rows_evicted",
              "victims_dropped_stale"):
        assert gc[k] == cc[k], k


# -- K16 seg_pull and K17 touch_dense (the streams plane) --------------------

def _pull_case(rng, dev, n_rows=8192, m=12_000):
    rows = np.sort(rng.integers(0, n_rows, m))
    rows = rows[rows % 9 != 0]            # some empty rows
    seg = np.zeros(n_rows + 1, np.int32)
    seg[1:] = np.cumsum(np.bincount(rows, minlength=n_rows))
    return torch.from_numpy(seg).to(dev), len(rows)


@pytest.mark.parametrize("mode", ["sum_int32", "sum_wrapping", "max_int32",
                                  "sum_float32", "count_slot",
                                  "short_offsets"])
def test_seg_pull_matches_plain(cuda_device, mode):
    """K16 against its plain version: int32 sums bit for bit (a batch whose
    row sums wrap too), the max with ``fill`` over empty rows, float32
    within ``2 * k * 2**-24 * sum|x|`` per row, the count mode adding
    into a column and a slot, lanes past ``offsets[-1]``."""
    from orleans_tpu_torch.kernels import pull as kpull

    rng = np.random.default_rng(len(mode))
    seg, m = _pull_case(rng, cuda_device)
    extra = 29 if mode == "short_offsets" else 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)

    if mode == "sum_float32":
        v = t((rng.standard_normal(m + extra) * 100).astype(np.float32))
        got = kpull.seg_pull(v, seg, "sum")
        want = kpull.seg_pull_plain(v, seg, "sum")
        k = (seg[1:] - seg[:-1]).double()
        mag = kpull.seg_pull_plain(v.abs(), seg, "sum").double()
        assert bool(((got.double() - want.double()).abs()
                     <= 2 * k * 2.0**-24 * mag).all())
        return
    if mode == "count_slot":
        v = t(rng.random(m + 13) < 0.7)
        c = t(rng.integers(0, 99, seg.shape[0] - 1).astype(np.int32))
        s = torch.zeros(16, dtype=torch.int32, device=cuda_device)
        c2, s2 = c.clone(), s.clone()
        kpull.seg_pull(v, seg, "sum", out=c, slots=s, slot=3)
        kpull.seg_pull_plain(v, seg, "sum", out=c2, slots=s2, slot=3)
        assert torch.equal(c, c2) and torch.equal(s, s2)
        assert int(s[3]) == int(v.sum())
        return
    hi = 2**31 - 1 if mode == "sum_wrapping" else 1000
    lo = -2**31 if mode == "sum_wrapping" else -1000
    v = t(rng.integers(lo, hi, m + extra, dtype=np.int64).astype(np.int32))
    if mode == "max_int32":
        got = kpull.seg_pull(v, seg, "max", fill=-7)
        assert torch.equal(got, kpull.seg_pull_plain(v, seg, "max", fill=-7))
        empty = seg[1:] == seg[:-1]
        assert bool(empty.any()) and bool((got[empty] == -7).all())
        return
    assert torch.equal(kpull.seg_pull(v, seg, "sum"),
                       kpull.seg_pull_plain(v, seg, "sum"))


def test_touch_dense_matches_plain(cuda_device):
    from orleans_tpu_torch.kernels import pull as kpull

    rng = np.random.default_rng(17)
    seg, _m = _pull_case(rng, cuda_device)
    clock = torch.from_numpy(rng.integers(-5, 60, seg.shape[0] - 1)
                             .astype(np.int32)).to(cuda_device)
    a, b = clock.clone(), clock.clone()
    kpull.touch_dense(a, seg, 41)
    kpull.touch_dense_plain(b, seg, 41)
    assert torch.equal(a, b)


def _chat(device, fused: bool):
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples.streams import run_chat_load
    from orleans_tpu_torch.tensor.engine import TensorEngine

    engine = TensorEngine(device=device, config=TensorEngineConfig(
        auto_fusion_ticks=3 if fused else 0, auto_fusion_window=4))
    stats = asyncio.run(run_chat_load(engine, n_rooms=64, n_users=3000,
                                      mean_memberships=1.5, n_ticks=24,
                                      verify=True))
    return engine, stats


def test_fused_chat_window_on_card_matches_unfused(cuda_device):
    """Chat auto-fused on the card (K16 captured into the graph windows,
    its count mode folding the attribution) equals the unfused engine on
    the CPU: every member column, the oracle, the ledger and the
    attribution totals."""
    from orleans_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    gpu, gstats = _chat(cuda_device, fused=True)
    report = _build.launch_report()["seg_pull"]
    cpu, cstats = _chat("cpu", fused=False)
    assert gpu.autofuser.snapshot()["ticks_fused"] > 0
    assert report["captured"] > 0 and report["replayed"] > 0
    assert all(v for k, v in gstats["oracle"].items() if k.endswith("_exact"))
    for name in ("ChatUserGrain", "ChatRoomGrain"):
        ga, ca = gpu.arena_for(name), cpu.arena_for(name)
        np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
        for col in ca.state:
            np.testing.assert_array_equal(ga.state[col].cpu().numpy(),
                                          ca.state[col].numpy(), err_msg=col)
        assert gpu.attribution.per_key_totals(name) == \
            cpu.attribution.per_key_totals(name), name
    assert gpu.ledger.fetch_counts().sum() == cpu.ledger.fetch_counts().sum()


# -- K18 and the hot-grain replicas (the routing sample) ----------------------

@pytest.mark.parametrize("n_groups", [1, 3, 9])
def test_spread_replicas_matches_plain(cuda_device, n_groups):
    """K18 against its plain version: G groups of k = 2..8 rows (9 groups
    pad the mirror to 16, so the padding is searched), 300,000 lanes aimed
    at primaries, other rows and -1; the lane hash wraps uint32."""
    from orleans_tpu_torch.kernels.replicas import (
        spread_replicas,
        spread_replicas_plain,
    )

    rng = np.random.default_rng(n_groups)
    g = 1 << max(0, n_groups - 1).bit_length()
    rows_all = rng.permutation(1 << 20)[:n_groups * 8].astype(np.int32)
    prim = np.full(g, KEY_SENTINEL, np.int32)
    counts = np.ones(g, np.int32)
    table = np.full((g, 8), -1, np.int32)
    order = np.argsort(rows_all[:n_groups])
    for i, j in enumerate(order):
        k = 2 + j % 7
        prim[i] = rows_all[j]
        counts[i] = k
        table[i, 0] = rows_all[j]
        table[i, 1:k] = rows_all[n_groups + 7 * j:n_groups + 7 * j + k - 1]
    m = 300_000
    rows = rng.integers(-1, 1 << 20, m).astype(np.int32)
    aim = rng.random(m) < 0.5
    rows[aim] = prim[rng.integers(0, n_groups, aim.sum())]
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (prim, counts, table, rows)]
    got = spread_replicas(*args)
    want = spread_replicas_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got != args[3]).sum()) > 0


def _routing_engine(device, fused: bool):
    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import routing
    from orleans_tpu_torch.tensor.engine import TensorEngine

    eng = TensorEngine(device=device, config=TensorEngineConfig(
        auto_fusion_ticks=8 if fused else 0))
    sources = np.arange(5000, dtype=np.int64)
    sinks = routing.sink_keys(32)
    eng.arena_for("RouteSource").reserve(5000)
    eng.arena_for("RouteSink").reserve(32)
    eng.arena_for("RouteSource").resolve_rows(sources)
    eng.arena_for("RouteSink").resolve_rows(sinks)
    return eng, sources, sinks


def _hot_sink_run(device, fused: bool):
    """5,000 sources all sending to one of 32 sinks for 24 ticks, the sink
    promoted to 8 rows before tick 8, demoted before tick 18 and promoted
    to 2 rows before tick 20; the fold checked against
    ``expected_sink_state``.  Returns the engine."""
    from orleans_tpu_torch.samples import routing

    eng, sources, sinks = _routing_engine(device, fused)
    hot = int(sinks[0])
    dst = torch.full((5000,), hot, dtype=torch.int32, device=device)
    values = torch.from_numpy(np.random.default_rng(1).integers(
        1, 8, 5000).astype(np.float32)).to(device)
    inj = eng.make_injector("RouteSource", "send", sources)
    for t in range(24):
        if t == 8:
            assert eng.replicate_key("RouteSink", hot, 8) == 8
        if t == 18:
            assert eng.demote_key("RouteSink", hot) == 7
        if t == 20:
            assert eng.replicate_key("RouteSink", hot, 2) == 2
        inj.inject({"dst": dst, "v": values, "tick": np.int32(t)})
        eng.run_tick()
    import asyncio
    asyncio.run(eng.flush())
    want_total, want_recv = routing.expected_sink_state(
        sources, np.full(5000, hot), values.cpu().numpy(), sinks, 24)
    arena = eng.arena_for("RouteSink")
    got = arena.read_row(hot)
    assert int(got["received"]) == want_recv[0]
    assert abs(float(got["total"]) - want_total[0]) <= \
        2 * want_recv[0] * 2.0**-24 * want_total[0]
    return eng


@pytest.mark.parametrize("fused", [False, True])
def test_promoted_routing_engine_on_card_matches_cpu(cuda_device, fused):
    """A hot sink promoted, demoted and promoted again while every source
    sends to it, unfused and auto-fused (K18 eager and replayed in the
    graph): the card equals the CPU port row for row, and a promote or
    demote between windows rebuilds the window (``replica_change``)."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.tensor.fused import CAUSE_REPLICA_CHANGE

    _build.reset_launch_counts()
    gpu = _hot_sink_run(cuda_device, fused)
    report = _build.launch_report()["spread_replicas"]
    cpu = _hot_sink_run("cpu", fused)
    assert report["eager"] > 0
    if fused:
        assert gpu.autofuser.snapshot() == cpu.autofuser.snapshot()
        assert gpu.autofuser.snapshot()["ticks_fused"] > 0
        assert report["captured"] > 0 and report["replayed"] > 0
        rebuilds = sum(p.rebuilds[CAUSE_REPLICA_CHANGE]
                       for p in gpu.autofuser._programs.values())
        assert rebuilds >= 1
    for name in ("RouteSource", "RouteSink"):
        ga, ca = gpu.arena_for(name), cpu.arena_for(name)
        np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
        for col in ca.state:
            np.testing.assert_array_equal(ga.state[col].cpu().numpy(),
                                          ca.state[col].numpy(), err_msg=col)
    assert gpu.attribution.per_key_totals("RouteSink") == \
        cpu.attribution.per_key_totals("RouteSink")


# -- the durable state plane (K19–K21) --------------------------------------

def _ckpt_columns(device, n):
    rng = np.random.default_rng(n)
    cols = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 9, (n, 3)).astype(np.int32),
            rng.random(n) < 0.5,
            rng.integers(0, 100, n).astype(np.int32)]
    return [torch.from_numpy(c).to(device) for c in cols]


@pytest.mark.parametrize("n", [1, 1001, 1 << 20])
def test_pin_columns_matches_plain(cuda_device, n):
    """K19 copies int32, float32, ``[n, 3]`` and bool columns (bodies of
    16-byte units, 1-byte tails) bit for bit, into new buffers and into
    odd-offset views of one byte buffer (4- and 1-byte units)."""
    from orleans_tpu_torch.kernels import checkpoint as kck

    cols = _ckpt_columns(cuda_device, n)
    got = kck.pin_columns(cols)
    torch.cuda.synchronize()
    for c, g in zip(cols, got):
        assert torch.equal(c, g) and c.data_ptr() != g.data_ptr()
    flat = torch.zeros(sum(c.numel() * c.element_size() for c in cols) + 9,
                       dtype=torch.uint8, device=cuda_device)
    out, off = [], 1  # the bool column first, at an odd offset
    order = [3, 0, 1, 2, 4]
    for i in order:
        c = cols[i]
        nb = c.numel() * c.element_size()
        off = -(-off // c.element_size()) * c.element_size()
        out.append(flat[off:off + nb].view(c.dtype).view(c.shape))
        off += nb
    kck.pin_columns([cols[i] for i in order], out)
    torch.cuda.synchronize()
    for i, o in zip(order, out):
        assert torch.equal(cols[i], o)


@pytest.mark.parametrize("m", [1, 1000, 65536])
def test_gather_columns_matches_plain(cuda_device, m):
    """K20 gathers every column into one packed staging buffer equal to
    the plain version's byte for byte; pad lanes and rows past the end
    clip; ``fetch_packed`` brings it over with one copy."""
    from orleans_tpu_torch.kernels import checkpoint as kck

    n = 200_000
    cols = _ckpt_columns(cuda_device, n)
    rng = np.random.default_rng(m)
    idx = rng.integers(-3, n + 3, m).astype(np.int32)
    idx_d = torch.from_numpy(idx).to(cuda_device)
    staging, views = kck.gather_columns(cols, idx_d)
    want_s, want_v = kck.gather_columns_plain(cols, idx_d)
    torch.cuda.synchronize()
    for v, w in zip(views, want_v):
        assert torch.equal(v, w)
    host = kck.fetch_packed(staging, cols, m)
    for h, w in zip(host, want_v):
        np.testing.assert_array_equal(h, w.cpu().numpy())


@pytest.mark.parametrize("mode", ["dirty", "touched"])
def test_dirty_mask_matches_plain(cuda_device, mode):
    from orleans_tpu_torch.kernels import checkpoint as kck

    rng = np.random.default_rng(7)
    n = 1 << 20
    counts = rng.integers(0, 4, n).astype(np.int32)
    pinned = np.where(rng.random(n) < 0.1, counts + 1, counts).astype(
        np.int32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (
        counts, pinned, rng.integers(0, 60, n).astype(np.int32),
        rng.integers(0, 60, n).astype(np.int32), rng.random(n) < 0.8)]
    if mode == "touched":
        t[0] = t[1] = None
    for cutoff in (30, 0, -2**31 + 1, 2**31 - 1):
        got = kck.dirty_mask(*t, cutoff)
        want = kck.dirty_mask_plain(*t, cutoff)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _banking_kill_recover(device):
    """Banking with a full, cadence deltas and sealed journal segments,
    killed mid-cadence and recovered (fused fold-replay windows)."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import banking
    from orleans_tpu_torch.tensor.checkpoint import MemorySnapshotStore
    from orleans_tpu_torch.tensor.engine import TensorEngine

    backing = {}
    cfg = TensorEngineConfig(auto_fusion_ticks=0, ckpt_full_every_ticks=16,
                             ckpt_delta_every_ticks=8,
                             journal_flush_every_ticks=3)
    eng = TensorEngine(device=device, config=cfg,
                       snapshot_store=MemorySnapshotStore(backing))
    banking.register_banking_journal(eng)
    events = banking.make_events(2000, 30, lanes=512, seed=3)
    for ev in events:
        banking.send_event(eng, ev)
        eng.run_tick()
    acked = sum(s.committed_lanes for s in
                eng.checkpointer.journal.sites.values()) // 512
    eng2 = TensorEngine(device=device, config=cfg,
                        snapshot_store=MemorySnapshotStore(backing))
    banking.register_banking_journal(eng2)
    stats = asyncio.run(eng2.checkpointer.recover())
    oracle = banking.BankOracle(2000)
    for ev in events[:acked]:
        oracle.apply(ev)
    keys = np.unique(np.concatenate(
        [np.concatenate([e["keys"], e.get("dst", np.empty(0, np.int64))])
         for e in events[:acked]]))
    got = banking.read_accounts(eng2, keys)
    for name, want in oracle.expect(keys).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    return eng2, stats


def test_banking_kill_recover_on_card_matches_cpu(cuda_device):
    """The durable state plane on the card (K19 pins and journal copies,
    K20 chunks, K21 dirty masks, fused fold-replay windows as graphs)
    recovers the acknowledged prefix exactly, row for row equal to the
    CPU port."""
    from orleans_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    gpu, gst = _banking_kill_recover(cuda_device)
    counts = _build.launch_counts()
    cpu, cst = _banking_kill_recover("cpu")
    assert gst == {**cst, "seconds": gst["seconds"]}
    assert gst["fused_windows"] > 0 and gpu.checkpointer.restored_rows > 0
    for name in ("pin_columns", "gather_columns", "dirty_mask"):
        assert counts[name] > 0, name
    ga, ca = gpu.arena_for("AccountGrain"), cpu.arena_for("AccountGrain")
    np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
    for col in ca.state:
        np.testing.assert_array_equal(ga.state[col].cpu().numpy(),
                                      ca.state[col].numpy(), err_msg=col)


def test_fused_window_rebuilds_after_adoption_on_card(cuda_device):
    """A captured window over an arena that a recovery point then replaces
    (a standby's adoption, the generation restored equal) rebuilds under
    ``restore`` before its next replay, and equals the unfused engine."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.samples import banking
    from orleans_tpu_torch.tensor.checkpoint import (
        MemorySnapshotStore,
        StandbyTailer,
    )
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.fused import CAUSE_RESTORE

    def engine(store=None):
        return TensorEngine(device=cuda_device, snapshot_store=store,
                            config=TensorEngineConfig(auto_fusion_ticks=0))

    backing = {}
    keys = np.arange(4096, dtype=np.int64)
    primary = engine(MemorySnapshotStore(backing))
    asyncio.run(banking.run_banking_load(primary, banking.make_events(
        4096, 4, lanes=4096, seed=9, transfer_every=0)))
    primary.checkpointer.checkpoint_full()
    standby, oracle = engine(), engine()
    asyncio.run(banking.run_banking_load(standby, [{
        "method": "deposit", "keys": keys[::-1].copy(),
        "amount": np.full(4096, 3, np.int32)}]))
    prog = standby.fuse_ticks("AccountGrain", "deposit", keys)
    stacked = {"amount": np.ones((8, 4096), np.int32)}
    prog.run(stacked)
    assert prog.verify() == 0
    for eng in (standby, oracle):
        StandbyTailer(eng, MemorySnapshotStore(backing)).poll()
    prog.run(stacked)
    assert prog.verify() == 0 and prog.rebuilds[CAUSE_RESTORE] == 1
    for _ in range(8):
        oracle.send_batch("AccountGrain", "deposit", keys,
                          {"amount": np.ones(4096, np.int32)})
        oracle.run_tick()
    asyncio.run(oracle.flush())
    got = banking.read_accounts(standby, keys)
    for name, want in banking.read_accounts(oracle, keys).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)


@pytest.mark.parametrize("double_tree", [False, True])
@pytest.mark.parametrize("bounds", [
    None, (0, 700, 700, 1500, 2048),
    (0, 100, 300, 301, 700, 700, 1500, 1800, 2048),
    tuple(range(0, 2048, 101)) + (2048,)])
def test_gather_args_matches_plain(cuda_device, bounds, double_tree):
    """K22 against its plain version bit for bit: bool, int16, int32,
    float32 ``[n]`` and ``[n, 4]``, uint8 ``[n, 3]``, int64 leaves (twice
    over with ``double_tree``: 14 leaves, two launches' worth), one
    permutation cut into segments (an empty one, a one-lane one, lengths
    not a multiple of a thread's 4 lanes, 40 and more pieces, 21 segments
    over two launches), m = 0 and out-of-range indices (both clip)."""
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.kernels import router as kr

    rng = np.random.default_rng(22)
    n = 4096
    leaves = [torch.from_numpy(a).to(cuda_device) for a in (
        rng.random(n) < 0.5, rng.integers(-2**15, 2**15, n, dtype=np.int16),
        rng.integers(-2**31, 2**31 - 1, n, dtype=np.int32),
        rng.random(n, dtype=np.float32), rng.random((n, 4), dtype=np.float32),
        rng.integers(0, 255, (n, 3), dtype=np.uint8),
        rng.integers(-2**62, 2**62, n, dtype=np.int64))]
    if double_tree:
        leaves = leaves + [x.flip(0).contiguous() for x in leaves]
    idx = rng.permutation(n)[:2048].astype(np.int32)
    idx[:3] = [-5, n, n + 100]
    idx_d = torch.from_numpy(idx).to(cuda_device)
    _build.reset_launch_counts()
    s, v, layout = kr.gather_args(leaves, idx_d, bounds)
    assert kr.gather_args.launches == len(kr.plan_gather(
        layout, range(len(leaves))))
    ws, wv, _ = kr.gather_args_plain(leaves, idx_d, bounds)
    # piece by piece: the alignment padding between pieces is unwritten
    for seg, want in zip(v, wv):
        for got, w in zip(seg, want):
            assert torch.equal(got, w)
    if bounds is not None:
        host = kr.fetch_segments(s, layout, leaves, leaves, first=1)
        for seg, views in zip(host, v[1:]):
            for h, d in zip(seg, views):
                np.testing.assert_array_equal(h, d.cpu().numpy())
    before = kr.gather_args.launches
    _, v0, _ = kr.gather_args(leaves, idx_d[:0])
    assert all(x.shape[0] == 0 for x in v0[0])
    assert kr.gather_args.launches == before  # m = 0 launches nothing


def test_two_silo_cluster_on_card_matches_cpu(cuda_device):
    """Cross-silo Presence over 2 silos on the card (K22 splits the device
    payload, remote games miss and ship) equals the same cluster on the
    CPU, key by key."""
    import asyncio

    import orleans_tpu_torch.samples.presence  # noqa: F401
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples.presence import run_presence_load
    from orleans_tpu_torch.testing import TestingCluster

    def drive(device):
        async def main():
            cluster = await TestingCluster(n_silos=2, device=device).start()
            try:
                a = cluster.silos[0]
                await run_presence_load(a.tensor_engine, n_players=20_000,
                                        n_games=200, n_ticks=12)
                await cluster.quiesce_engines()
                out = {}
                for s in cluster.silos:
                    for t, arena in s.tensor_engine.arenas.items():
                        for k in arena.keys().tolist():
                            assert (t, k) not in out
                            out[(t, k)] = {c: np.asarray(x) for c, x in
                                           arena.read_row(k).items()}
                return out
            finally:
                await cluster.stop()
        return asyncio.run(main())

    _build.reset_launch_counts()
    gpu = drive(cuda_device)
    counts = _build.launch_counts()
    cpu = drive("cpu")
    for name in ("gather_args", "miss_keys", "seg_sum"):
        assert counts[name] > 0, name
    assert set(gpu) == set(cpu)
    for key, want in cpu.items():
        for c, w in want.items():
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(gpu[key][c], w, rtol=1e-5)
            else:
                np.testing.assert_array_equal(gpu[key][c], w, err_msg=c)


# -- the cross-shard exchange (K23, K24) -------------------------------------

def _exchange_lanes(device, m, n, sc, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n * sc, m).astype(np.int32)
    rows[rng.random(m) < 0.05] = -1
    rows[rng.random(m) < 0.01] = n * sc  # past the arena: invalid
    mask = rng.random(m) < 0.95
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.parametrize("m,L", [(1000, 128), (997, 128), (300_000, 49152)])
@pytest.mark.parametrize("mode", ["probe", "cap0"])
def test_exchange_classify_matches_plain(cuda_device, m, L, mode):
    from orleans_tpu_torch.kernels import exchange as kx

    n, sc = 8, 4096
    rows, mask = _exchange_lanes(cuda_device, m, n, sc, seed=m + L)
    got = kx.exchange_classify(rows, mask, sc, L, n, mode)
    want = kx.exchange_classify_plain(rows, mask, sc, L, n, mode)
    torch.cuda.synchronize()
    for a, b in zip(got if mode == "cap0" else (got,),
                    want if mode == "cap0" else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["legacy_fit", "legacy_overflow",
                                    "perdest", "perdest_recv_overflow"])
@pytest.mark.parametrize("m,L", [(997, 128), (300_000, 49152)])
def test_exchange_buckets_matches_plain(cuda_device, layout, m, L):
    """K24 in both layouts, bit for bit: rows, a 4-byte, an 8-byte and a
    2-D leaf, mask, dropped lanes and stats — tiles that split a chunk,
    ragged lanes, and send and receive overflow."""
    from orleans_tpu_torch.kernels import exchange as kx

    n, sc = 8, 4096
    rows, mask = _exchange_lanes(cuda_device, m, n, sc, seed=m)
    rng = np.random.default_rng(1)
    leaves = [torch.from_numpy(x).to(cuda_device) for x in (
        rng.standard_normal(m).astype(np.float32),
        rng.integers(-2**62, 2**62, m, dtype=np.int64),
        rng.integers(0, 9, (m, 3)).astype(np.int32))]
    per = max(1, L // n)
    plan = {"legacy_fit": dict(cap=L),
            "legacy_overflow": dict(cap=max(1, per // 2)),
            "perdest": dict(caps=[L] * n, R=n * L),
            "perdest_recv_overflow": dict(caps=[per // 2, per, 0, per,
                                                per * 2, per, 3, per],
                                          R=max(1, per * 3))}[layout]
    got = kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)
    want = kx.exchange_buckets_plain(rows, mask, leaves, sc, L, n, **plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)
    dropped = int(want[4][1])
    assert (dropped > 0) == layout.endswith("overflow")


def _k24_same(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a, b)


def _k24_inputs(device, n, case, layout, offset=0):
    """Lanes over ``n`` blocks of 97 rows with L = 3001 (no multiple of
    the 1024-lane tile, chunks at every 4-byte phase), 17 lanes short of n
    chunks; leaves of 1, 2, 12 and 16 bytes a lane; every tensor a view
    ``offset`` elements into a larger one (4 bytes off for the rows)."""
    L, sc = 3001, 97
    m = n * L - 17
    rng = np.random.default_rng(n * 7 + len(case))
    chunk = np.minimum(np.arange(m) // L, n - 1)
    dest = np.where(rng.random(m) < 0.6,
                    (chunk + rng.integers(1, max(n, 2), m)) % n, chunk)
    if case == "one_dest":
        dest[:] = n - 1
    rows = (dest * sc + rng.integers(0, sc, m)).astype(np.int32)
    rows[rng.random(m) < 0.04] = -1
    mask = rng.random(m) < 0.95

    def view(a):
        t = torch.from_numpy(np.concatenate(
            [np.zeros((offset, *a.shape[1:]), a.dtype), a])).to(device)
        return t[offset:]

    leaves = [view(rng.integers(0, 255, m).astype(np.uint8)),
              view(rng.integers(-9, 9, m).astype(np.int16)),
              view(rng.integers(0, 9, (m, 3)).astype(np.int32)),
              view(rng.integers(-2**62, 2**62, (m, 2), dtype=np.int64))]
    per = max(1, L // max(n, 1))
    cap = {"spread": per + 5, "one_dest": L, "all_dropped": 0,
           "cap1": 1}[case]
    if layout == "legacy":
        plan = dict(cap=max(cap, 1)) if case != "all_dropped" else \
            dict(cap=1)
    else:
        plan = dict(caps=[cap] * n, R=max(1, n * cap // 2))
    if case == "all_dropped" and layout == "legacy":
        mask[:] = mask & (dest != chunk)  # every valid lane crosses
    return view(rows), view(mask), leaves, sc, L, n, plan


@pytest.mark.parametrize("layout", ["legacy", "perdest"])
@pytest.mark.parametrize("case", ["spread", "one_dest", "all_dropped",
                                  "cap1"])
@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_exchange_buckets_shapes_match_plain(cuda_device, n, case, layout):
    """K24 bit for bit at 1, 2, 8 (the ballot path) and 64 blocks (the
    match path): L off the tile, every lane bound for one destination,
    everything dropped (caps 0, or cap 1 with every lane crossing), cap 1,
    leaves of 1, 2, 12 and 16 bytes."""
    from orleans_tpu_torch.kernels import exchange as kx

    rows, mask, leaves, sc, L, n, plan = _k24_inputs(cuda_device, n, case,
                                                     layout)
    got = kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)
    want = kx.exchange_buckets_plain(rows, mask, leaves, sc, L, n, **plan)
    _k24_same(got, want)
    if case == "all_dropped" and layout == "perdest":
        assert int(want[4][1]) == int(want[4][0])


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("layout", ["legacy", "perdest"])
def test_exchange_buckets_views_off_alignment(cuda_device, layout, offset):
    """Every input a view ``offset`` elements into its storage (the rows
    4 or 12 bytes off a 16-byte line): the kernel's scalar paths."""
    from orleans_tpu_torch.kernels import exchange as kx

    rows, mask, leaves, sc, L, n, plan = _k24_inputs(
        cuda_device, 8, "spread", layout, offset=offset)
    assert rows.data_ptr() % 16 != 0
    got = kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)
    want = kx.exchange_buckets_plain(rows, mask, leaves, sc, L, n, **plan)
    _k24_same(got, want)


@pytest.mark.parametrize("layout", ["legacy", "perdest"])
def test_exchange_buckets_graph_replay(cuda_device, layout):
    """K24 captured into a CUDA graph and replayed on new lanes written
    into its inputs: the replay equals the plain version on them."""
    from orleans_tpu_torch.kernels import exchange as kx

    rows, mask, leaves, sc, L, n, plan = _k24_inputs(cuda_device, 8,
                                                     "spread", layout)
    rows, mask = rows.clone(), mask.clone()
    leaves = [x.clone() for x in leaves]
    kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)  # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kx.exchange_buckets(rows, mask, leaves, sc, L, n, **plan)
    r2, m2, l2, *_ = _k24_inputs(cuda_device, 8, "one_dest", layout)
    rows.copy_(r2)
    mask.copy_(m2)
    for x, y in zip(leaves, l2):
        x.copy_(y)
    graph.replay()
    want = kx.exchange_buckets_plain(rows, mask, leaves, sc, L, n, **plan)
    _k24_same(out, want)


def _count_entries(device, ms, seed):
    """One count a length of ``ms``, base and rows views at odd offsets
    (base 1 to 15 bytes, rows 4 bytes off), into two histograms."""
    rng = np.random.default_rng(seed)
    ha = torch.from_numpy(rng.integers(0, 9, (16, 8)).astype(
        np.int32)).to(device)
    hb = torch.zeros((1, 2), dtype=torch.int32, device=device)
    entries = []
    for k, m in enumerate(ms):
        off = k % 16
        base = torch.from_numpy(rng.random(m + off) < 0.7).to(device)[off:]
        rows = torch.from_numpy(rng.integers(-5, 50, m + 1).astype(
            np.int32)).to(device)[k % 2:k % 2 + m]
        h, slot, bucket = (ha, k % 16, k % 8) if k % 3 else (hb, 0, k % 2)
        entries.append((h, slot, bucket, base, rows if k % 2 else None))
    return ha, hb, entries


@pytest.mark.parametrize("ms", [[1_000_000], [5, 0, 1_000_003],
                                [17, 1, 15, 16, 4099, 0, 70_001, 3],
                                [0], [300_001] * 8 + [9, 12]])
def test_hist_count_many_matches_plain(cuda_device, ms):
    """K5's multi-count: 1 to 10 entries (past 8 a second launch), empty
    entries, lengths below a 16-lane group, bases at odd offsets, rows
    off the mask's alignment; exactly the plain version's counts."""
    from orleans_tpu_torch.kernels import hist

    ha, hb, entries = _count_entries(cuda_device, ms, len(ms))
    wa, wb = ha.clone(), hb.clone()
    plain = [((wa if e[0] is ha else wb), *e[1:]) for e in entries]
    hist.hist_count_many(entries)
    hist.hist_count_many_plain(plain)
    torch.cuda.synchronize()
    assert torch.equal(ha, wa) and torch.equal(hb, wb)


def test_hist_count_many_graph_replay(cuda_device):
    """A tick's counts captured as one launch and replayed twice: each
    cell gains twice its count."""
    from orleans_tpu_torch.kernels import _build, hist

    ha, hb, entries = _count_entries(cuda_device, [100_000, 7, 333], 3)
    wa, wb = ha.clone(), hb.clone()
    plain = [((wa if e[0] is ha else wb), *e[1:]) for e in entries]
    hist.hist_count_many(entries)  # warm: the library and the wave
    hist.hist_count_many_plain(plain)
    torch.cuda.synchronize()
    before = _build.captured_counts()["hist_count"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hist.hist_count_many(entries)
    assert _build.captured_counts()["hist_count"] == before + 1
    graph.replay()
    graph.replay()
    hist.hist_count_many_plain(plain)
    hist.hist_count_many_plain(plain)
    torch.cuda.synchronize()
    assert torch.equal(ha, wa) and torch.equal(hb, wb)


@pytest.mark.parametrize("fused", [0, 4])
def test_routing_sweep_on_card_matches_cpu(cuda_device, fused):
    """The routing load over 8 blocks at ratio 0.5 with the structured
    exchange, unfused and in fused windows (K24 eager and replayed in the
    graph): the card equals the CPU port row for row and the exchange's
    counters agree."""
    import asyncio

    from orleans_tpu_torch.config import TensorEngineConfig
    from orleans_tpu_torch.kernels import _build
    from orleans_tpu_torch.samples import routing
    from orleans_tpu_torch.tensor.engine import TensorEngine
    from orleans_tpu_torch.tensor.mesh import ShardMesh

    def run(device):
        e = TensorEngine(mesh=ShardMesh(8, device), device=device,
                         config=TensorEngineConfig(
                             auto_fusion_ticks=0,
                             exchange_structured="always"))
        asyncio.run(routing.run_routing_load(e, 20_000, 2_048, 0.5,
                                             n_ticks=8, fused_window=fused))
        return e

    _build.reset_launch_counts()
    gpu = run(cuda_device)
    counts = _build.launch_counts()
    cpu = run("cpu")
    assert counts["exchange_buckets"] > 0
    for name in ("RouteSource", "RouteSink"):
        ga, ca = gpu.arena_for(name), cpu.arena_for(name)
        np.testing.assert_array_equal(ga._key_of_row, ca._key_of_row)
        for col in ca.state:
            np.testing.assert_array_equal(ga.state[col].cpu().numpy(),
                                          ca.state[col].numpy(), err_msg=col)
    gx, cx = gpu.stats()["exchange"], cpu.stats()["exchange"]
    for k in ("exchanges_run", "cross_shard_msgs", "delivered_msgs",
              "dropped_msgs", "sites"):
        assert gx[k] == cx[k], k
