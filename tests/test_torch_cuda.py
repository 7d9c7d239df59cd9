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
