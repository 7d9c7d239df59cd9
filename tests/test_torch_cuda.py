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


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_seg_sum_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(2)
    rows = _rows(rng, N_ROWS, M)
    vals = rng.integers(-50, 50, M).astype(np.int32) if dtype == torch.int32 \
        else rng.standard_normal(M).astype(np.float32)
    v_d = torch.from_numpy(vals).to(cuda_device)
    r_d = torch.from_numpy(rows).to(cuda_device)
    got = segment.seg_sum(v_d, r_d, N_ROWS)
    want = segment.seg_sum_plain(v_d, r_d, N_ROWS)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        tol = _fan_in_tol(vals, rows, N_ROWS)
        assert np.all(np.abs((got - want).cpu().numpy()) <= tol)


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


def test_resolve_adds_into_a_given_counter(cuda_device):
    dense = torch.tensor([0, -1, 2], dtype=torch.int32, device=cuda_device)
    keys = torch.tensor([0, 1, 2, 5], dtype=torch.int32, device=cuda_device)
    valid = torch.ones(4, dtype=torch.bool, device=cuda_device)
    total = torch.full((1, 2), 10, dtype=torch.int32, device=cuda_device)
    resolve.resolve_dense(dense, keys, valid, misses=total[0, 0])
    resolve.resolve_dense(dense, keys, valid, misses=total[0, 0])
    assert total.tolist() == [[14, 10]]


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
