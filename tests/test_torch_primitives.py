"""Differential tests of the port's primitives against the JAX package.

Every case draws its inputs with numpy from a seed and feeds the same
arrays to the JAX function (on the CPU, as tier-1 runs it) and to its
counterpart in ``orleans_tpu_torch`` (on CPU tensors, where each kernel
wrapper takes its plain PyTorch version; the CUDA kernels are held against
those plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Integers must match exactly.  Float sums
must match within twice Higham's bound for recursive summation, since the
two libraries may add in different orders: per row,
``2 * (k - 1) * 2**-24 * sum|x|`` for ``k`` terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu import hashing as jax_hashing
from orleans_tpu.core.grain import method_id_of as jax_method_id_of
from orleans_tpu.ids import type_code_of as jax_type_code_of
from orleans_tpu.tensor.vector_grain import (
    scatter_add_rows as jax_scatter_add_rows,
    scatter_rows as jax_scatter_rows,
    seg_max as jax_seg_max,
    seg_mean as jax_seg_mean,
    seg_sum as jax_seg_sum,
)
from orleans_tpu.tensor.arena import _touch_kernel
from orleans_tpu.tensor.engine import (
    _miss_keys_kernel,
    _resolve_rows_dense_kernel,
    _resolve_rows_kernel,
)
from orleans_tpu.tensor.ledger import (
    MAX_SLOTS,
    _count_rows_kernel,
    accumulate as jax_accumulate,
)

from orleans_tpu_torch import hashing
from orleans_tpu_torch.core.grain import method_id_of
from orleans_tpu_torch.ids import type_code_of
from orleans_tpu_torch.kernels.resolve import (
    KEY_SENTINEL,
    resolve_dense,
    resolve_sorted,
)
from orleans_tpu_torch.kernels.hist import hist_count
from orleans_tpu_torch.kernels.miss import miss_keys
from orleans_tpu_torch.kernels.scatter import row_scatter
from orleans_tpu_torch.tensor.ledger import accumulate
from orleans_tpu_torch.tensor.vector_grain import (
    scatter_add_rows,
    scatter_rows,
    seg_max,
    seg_mean,
    seg_sum,
)
from orleans_tpu_torch.tensor.engine import _miss_keys

N_ROWS = 64   # column / arena rows
M = 200       # lanes


def _t(a):
    """A CPU tensor holding its own copy of ``a`` (in-place safe)."""
    return torch.from_numpy(np.array(a, copy=True))


def _fan_in_tol(values, rows, n_rows, base=None):
    """Per-element bound ``2 * (k - 1) * 2**-24 * sum|x|`` over the k terms
    summed into each row: the kept lanes, plus ``base`` (the column's
    value before an in-place add) when given."""
    keep = (rows >= 0) & (rows < n_rows)
    flat = np.abs(values[keep].reshape(keep.sum(), -1)).astype(np.float64)
    k = np.bincount(rows[keep], minlength=n_rows)[:, None]
    mag = np.stack([np.bincount(rows[keep], weights=flat[:, j],
                                minlength=n_rows)
                    for j in range(flat.shape[1])], axis=1)
    if base is not None:
        k = k + 1
        mag = mag + np.abs(base.reshape(n_rows, -1))
    tol = 2 * np.maximum(k - 1, 0) * 2.0**-24 * mag
    return tol.reshape(n_rows, *values.shape[1:])


def _lane_rows(rng, n_rows, m, unique=False):
    """Rows with padding (-1) and past-the-end (>= n_rows) lanes mixed in;
    ``unique`` keeps the in-range rows distinct (SET is order-free only
    without duplicates)."""
    if unique:
        rows = rng.permutation(n_rows)[:m].astype(np.int32)
    else:
        rows = rng.integers(0, n_rows, m).astype(np.int32)
    bad = rng.random(len(rows)) < 0.2
    rows[bad] = rng.choice(np.array([-1, n_rows, n_rows + 7, 2**31 - 1],
                                    np.int32), bad.sum())
    return rows


def _values(rng, dtype, m, inner=()):
    if dtype == np.float32:
        return rng.standard_normal((m, *inner)).astype(np.float32)
    return rng.integers(-1000, 1000, (m, *inner)).astype(np.int32)


# -- host helpers -------------------------------------------------------------

@pytest.mark.parametrize("name", ["PresenceGrain", "GameGrain",
                                  "heartbeat", "update_game_status",
                                  "a-much-longer-name-than-one-block"])
def test_type_and_method_codes_match(name):
    data = name.encode()
    assert hashing.jenkins_hash(data) == jax_hashing.jenkins_hash(data)
    assert type_code_of(name) == jax_type_code_of(name)
    assert method_id_of(name) == jax_method_id_of(name)


@pytest.mark.parametrize("x", [0, 1, 2**31 - 1, 2**63 + 5, 12345678901234])
def test_stable_hash_u64_matches(x):
    assert hashing.stable_hash_u64(x) == jax_hashing.stable_hash_u64(x)


# -- K3 through scatter_rows / scatter_add_rows -------------------------------

@pytest.mark.parametrize("inner", [(), (3,)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["set", "add"])
def test_scatter_matches_jax(op, dtype, inner):
    rng = np.random.default_rng(11)
    col = _values(rng, dtype, N_ROWS, inner)
    m = N_ROWS // 2 if op == "set" else M
    rows = _lane_rows(rng, N_ROWS, m, unique=(op == "set"))
    vals = _values(rng, dtype, len(rows), inner)
    jfn = jax_scatter_rows if op == "set" else jax_scatter_add_rows
    tfn = scatter_rows if op == "set" else scatter_add_rows
    want = np.asarray(jfn(jnp.asarray(col), jnp.asarray(rows),
                          jnp.asarray(vals)))
    column = _t(col)
    got = tfn(column, _t(rows), _t(vals))
    assert got is column  # in place, returned
    if dtype == np.float32 and op == "add":
        tol = _fan_in_tol(vals, rows, N_ROWS, base=col)
        assert np.all(np.abs(got.numpy() - want) <= tol)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["set", "add", "max"])
def test_scatter_broadcasts_host_scalar(op):
    """The heartbeat's ``tick`` rides as a host scalar."""
    rng = np.random.default_rng(12)
    col = rng.integers(0, 10, N_ROWS).astype(np.int32)
    rows = _lane_rows(rng, N_ROWS, N_ROWS // 2, unique=True)
    ref = {"set": jax_scatter_rows, "add": jax_scatter_add_rows,
           "max": lambda c, r, v: _touch_kernel(c, r, v)}[op]
    want = np.asarray(ref(jnp.asarray(col), jnp.asarray(rows),
                          jnp.int32(7)))
    got = row_scatter(_t(col), _t(rows), np.int32(7), op)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["set", "add", "max"])
def test_scatter_broadcasts_device_scalar(op):
    """A 0-d tensor broadcasts like a host scalar — on the card it is read
    through its pointer (the fused window's per-tick ``tick``)."""
    rng = np.random.default_rng(14)
    col = rng.integers(0, 10, (N_ROWS, 2)).astype(np.int32)
    rows = _lane_rows(rng, N_ROWS, N_ROWS // 2, unique=True)
    want = row_scatter(_t(col), _t(rows), np.int32(8), op)
    got = row_scatter(_t(col), _t(rows), torch.tensor(8, dtype=torch.int32),
                      op)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = {"set": jax_scatter_rows, "add": jax_scatter_add_rows,
           "max": lambda c, r, v: _touch_kernel(c, r, v)}[op]
    if op != "max":  # _touch_kernel takes a 1-D use clock
        jwant = ref(jnp.asarray(col), jnp.asarray(rows),
                    jnp.broadcast_to(jnp.int32(8), (len(rows), 2)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_scatter_helpers_drop_padding_rows():
    """Mirror of tests/test_tensor_engine.py: padding rows (-1) drop, they
    do not wrap onto the last row."""
    col = torch.zeros(4, dtype=torch.int32)
    rows = torch.tensor([-1, 1, -1, 3], dtype=torch.int32)
    vals = torch.tensor([9, 5, 9, 7], dtype=torch.int32)
    np.testing.assert_array_equal(
        scatter_rows(col.clone(), rows, vals).numpy(), [0, 5, 0, 7])
    np.testing.assert_array_equal(
        scatter_add_rows(col.clone(), rows, vals).numpy(), [0, 5, 0, 7])


@pytest.mark.parametrize("bad", ["rows_int64", "values_float", "meta"])
def test_row_scatter_rejects_bad_inputs(bad):
    col = torch.zeros(8, dtype=torch.int32)
    rows = torch.zeros(3, dtype=torch.int32)
    vals = torch.ones(3, dtype=torch.int32)
    if bad == "rows_int64":
        rows = rows.long()
    elif bad == "values_float":
        vals = vals.float()
    else:
        col, rows, vals = (x.to("meta") for x in (col, rows, vals))
    with pytest.raises((TypeError, ValueError)):
        row_scatter(col, rows, vals, "set")


# -- K4 and the reductions built on it ----------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("fn", ["seg_sum", "seg_max", "seg_mean"])
def test_segment_reductions_match_jax(fn, dtype):
    rng = np.random.default_rng(13)
    rows = _lane_rows(rng, N_ROWS, M)
    rows[rows == 5] = 6  # row 5 stays empty: the reductions' identity
    vals = _values(rng, dtype, M)
    jax_fn, port_fn = {"seg_sum": (jax_seg_sum, seg_sum),
                       "seg_max": (jax_seg_max, seg_max),
                       "seg_mean": (jax_seg_mean, seg_mean)}[fn]
    want = np.asarray(jax_fn(jnp.asarray(vals), jnp.asarray(rows), N_ROWS))
    got = port_fn(_t(vals), _t(rows), N_ROWS).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if fn == "seg_max" or (fn == "seg_sum" and dtype == np.int32):
        np.testing.assert_array_equal(got, want)
        return
    tol = _fan_in_tol(vals, rows, N_ROWS)
    if fn == "seg_mean":
        keep = (rows >= 0) & (rows < N_ROWS)
        count = np.maximum(np.bincount(rows[keep], minlength=N_ROWS), 1)
        tol = tol / count + 2.0**-23 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


def test_pull_mode_segments_not_ported():
    """The pull-mode ``segments`` branches are ported now (K16; the full
    differential is tests/test_torch_streams.py): a small case against
    JAX, an empty row reading ``fill`` included."""
    vals = np.array([3, -1, 4, 1, 5], np.int32)
    seg = np.array([0, 2, 2, 5], np.int32)
    rows = np.array([0, 0, 2, 2, 2], np.int32)
    for fn, jfn, kw in ((seg_sum, jax_seg_sum, {}),
                        (seg_max, jax_seg_max, {"fill": -7})):
        want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(rows), 3,
                              segments=jnp.asarray(seg), **kw))
        got = fn(torch.from_numpy(vals), torch.from_numpy(rows), 3,
                 segments=torch.from_numpy(seg), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# -- K1 / K2 resolve ----------------------------------------------------------

def _resolve_lanes(rng, m, key_hi):
    """Keys mixing hits, unseen keys, out-of-range, negative and sentinel
    keys, plus a random valid mask."""
    keys = rng.integers(0, key_hi, m).astype(np.int32)
    odd = rng.random(m)
    keys[odd < 0.1] = KEY_SENTINEL
    keys[(odd >= 0.1) & (odd < 0.15)] = -3
    keys[(odd >= 0.15) & (odd < 0.2)] = key_hi + 1000
    valid = rng.random(m) < 0.85
    return keys, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_dense_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dense = rng.permutation(N_ROWS * 2).astype(np.int32)[:N_ROWS]
    dense[rng.random(N_ROWS) < 0.3] = -1  # unseen keys
    keys, valid = _resolve_lanes(rng, M, N_ROWS + 8)
    want_rows, want_miss = _resolve_rows_dense_kernel(
        jnp.asarray(dense), jnp.asarray(keys), jnp.asarray(valid))
    rows, miss = resolve_dense(_t(dense), _t(keys), _t(valid))
    assert rows.dtype == torch.int32 and miss.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert int(miss) == int(want_miss)


@pytest.mark.parametrize("live", [0, 1, 40])
def test_resolve_sorted_matches_jax(live):
    """``live=0`` is the empty arena of the cold tick: every key misses."""
    rng = np.random.default_rng(live)
    cap = N_ROWS
    keys_live = np.sort(rng.choice(500, live, replace=False)).astype(np.int32)
    sorted_keys = np.concatenate(
        [keys_live, np.full(cap - live, KEY_SENTINEL, np.int32)])
    sorted_rows = np.concatenate(
        [rng.permutation(cap)[:live].astype(np.int32),
         np.full(cap - live, -1, np.int32)])
    keys, valid = _resolve_lanes(rng, M, 500)
    if live:
        keys[:20] = rng.choice(keys_live, 20)  # guaranteed hits
    want_rows, want_miss = _resolve_rows_kernel(
        jnp.asarray(sorted_keys), jnp.asarray(sorted_rows),
        jnp.asarray(keys), jnp.asarray(valid))
    rows, miss = resolve_sorted(_t(sorted_keys), _t(sorted_rows), _t(keys),
                                _t(valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert int(miss) == int(want_miss)


def _miss_case(kind, rng):
    """(keys, rows, valid) for K6's adversarial cases."""
    m = M
    if kind == "many_unique":   # every lane a distinct unseen key
        keys = rng.permutation(10 * m)[:m].astype(np.int32)
        rows = np.full(m, -1, np.int32)
        valid = np.ones(m, bool)
    elif kind == "all_duplicate":
        keys = np.full(m, 41, np.int32)
        rows = np.where(rng.random(m) < 0.7, -1, 2).astype(np.int32)
        valid = rng.random(m) < 0.9
    elif kind == "sentinel_lanes":  # sentinel, negative and hit lanes
        keys, valid = _resolve_lanes(rng, m, 60)
        rows = np.where(rng.random(m) < 0.6, -1, 9).astype(np.int32)
    else:  # "none_missing"
        keys = rng.integers(0, 50, m).astype(np.int32)
        rows = rng.integers(0, 50, m).astype(np.int32)
        valid = np.ones(m, bool)
    return keys, rows, valid


@pytest.mark.parametrize("miss_buf", [1, 16, 512])
@pytest.mark.parametrize("kind", ["many_unique", "all_duplicate",
                                  "sentinel_lanes", "none_missing"])
def test_miss_keys_kernel_plain_matches_jax(kind, miss_buf):
    """K6 on the CPU (its plain version) against ``_miss_keys_kernel``:
    more unique misses than ``miss_buf`` keep the smallest, duplicates
    collapse, sentinel/negative/hit lanes sort or drop as JAX's do."""
    rng = np.random.default_rng(len(kind) * miss_buf)
    keys, rows, valid = _miss_case(kind, rng)
    want_keys, want_missing = _miss_keys_kernel(
        jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(valid),
        miss_buf=miss_buf)
    got_keys, got_missing = miss_keys(_t(keys), _t(rows), _t(valid),
                                      miss_buf)
    assert got_keys.dtype == torch.int32 and got_keys.shape == (miss_buf,)
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(got_missing.numpy(),
                                  np.asarray(want_missing))


@pytest.mark.parametrize("miss_buf", [8, 256])
def test_miss_keys_matches_jax(miss_buf):
    """``miss_buf=8`` holds fewer than the unique misses: both keep the
    smallest ones."""
    rng = np.random.default_rng(miss_buf)
    keys, valid = _resolve_lanes(rng, M, 100)
    rows = np.where(rng.random(M) < 0.5, -1, 3).astype(np.int32)
    want_keys, want_missing = _miss_keys_kernel(
        jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(valid),
        miss_buf=miss_buf)
    got_keys, got_missing = _miss_keys(_t(keys), _t(rows), _t(valid),
                                       miss_buf)
    np.testing.assert_array_equal(got_keys.numpy(), np.asarray(want_keys))
    np.testing.assert_array_equal(got_missing.numpy(),
                                  np.asarray(want_missing))


@pytest.mark.parametrize("tick", [1, 50])
def test_touch_max_matches_jax(tick):
    rng = np.random.default_rng(tick)
    last_use = rng.integers(0, 40, N_ROWS).astype(np.int32)
    rows = _lane_rows(rng, N_ROWS, M)
    want = np.asarray(_touch_kernel(jnp.asarray(last_use), jnp.asarray(rows),
                                    jnp.int32(tick)))
    got = row_scatter(_t(last_use), _t(rows), tick, "max")
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_max_scatter_matches_jax():
    rng = np.random.default_rng(21)
    col = rng.standard_normal(N_ROWS).astype(np.float32)
    rows = _lane_rows(rng, N_ROWS, M)
    vals = rng.standard_normal(M).astype(np.float32)
    safe = np.where(rows >= 0, rows, N_ROWS)
    want = np.asarray(jnp.asarray(col).at[safe].max(vals, mode="drop"))
    got = row_scatter(_t(col), _t(rows), _t(vals), "max")
    np.testing.assert_array_equal(got.numpy(), want)


# -- K5 hist_count and the ledger's accumulate ---------------------------------

@pytest.mark.parametrize("with_rows", [True, False])
@pytest.mark.parametrize("slot,bucket", [(0, 0), (3, 5), (MAX_SLOTS - 1, 15)])
def test_hist_count_matches_jax(slot, bucket, with_rows):
    """K5 with rows against ``_count_rows_kernel``; without rows against
    the fused window's ``hist.at[slot, 0].add(sum(mask))`` at any cell."""
    rng = np.random.default_rng(slot * 16 + bucket)
    hist = rng.integers(0, 50, (MAX_SLOTS, 16)).astype(np.int32)
    base = rng.random(M) < 0.7
    rows = _lane_rows(rng, N_ROWS, M)
    if with_rows:
        want = _count_rows_kernel(jnp.asarray(hist), jnp.int32(slot),
                                  jnp.int32(bucket), jnp.asarray(rows),
                                  jnp.asarray(base))
        got = hist_count(_t(hist), slot, bucket, _t(base), _t(rows))
    else:
        want = jnp.asarray(hist).at[jnp.int32(slot), bucket].add(
            jnp.sum(jnp.asarray(base, jnp.int32)))
        got = hist_count(_t(hist), slot, bucket, _t(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hist_count_rejects_cell_outside():
    hist = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(IndexError):
        hist_count(hist, 4, 0, torch.ones(3, dtype=torch.bool))


def test_accumulate_matches_jax():
    """The ledger's per-lane-delta update (plain torch; no engine path
    calls it) against ``ledger.accumulate``."""
    rng = np.random.default_rng(30)
    hist = rng.integers(0, 9, (MAX_SLOTS, 16)).astype(np.int32)
    deltas = rng.integers(-3, 70000, M).astype(np.int32)
    valid = rng.random(M) < 0.8
    want = jax_accumulate(jnp.asarray(hist), 5, jnp.asarray(deltas),
                          jnp.asarray(valid))
    got = accumulate(_t(hist), 5, _t(deltas), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
