"""The shape-side plans of K4 ``seg_sum`` and K8 ``attr_apply``, on the
CPU: what the CUDA kernels compute from the plans is emulated in numpy and
held against the plain version and the JAX function.

* K4: ``seg_plan`` picks the path from shapes alone (direct atomics, or
  the output privatized in each block's shared memory and summed over a
  thread-block cluster); the cluster's split of the output words covers
  each word once; an emulation of the privatized path (the warps' runs of
  elements dealt to blocks, a warp whose 32 elements share one word summed
  first, each block's own copy, each cluster's copies summed and flushed
  once per nonzero word) equals ``seg_sum_plain`` and JAX ``seg_sum``:
  int32 exactly, float32 within twice Higham's bound.
* K8: ``apply_split`` walks an accumulator and its delta as a scalar
  head, 16-byte groups and a scalar tail (word by word where the two
  differ in their address modulo 16); an emulation that touches a group
  only where its delta is nonzero equals ``attr_apply_plain`` and JAX
  ``_apply_coalesced``, k = 0 and int32 wrap included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.tensor import attribution as jattr
from orleans_tpu.tensor.vector_grain import seg_sum as jax_seg_sum
from orleans_tpu_torch.kernels import attr, segment
from orleans_tpu_torch.kernels.segment import seg_plan

RUN = 32 * 4  # elements of a warp's run: 4 a thread, strided by 32


def _fan_in_tol(values, rows, n_rows):
    """Twice Higham's bound per output element over its k terms."""
    keep = (rows >= 0) & (rows < n_rows)
    inner = int(np.prod(values.shape[1:], dtype=np.int64))
    flat = np.abs(values[keep].reshape(keep.sum(), inner)).astype(
        np.float64)
    k = np.bincount(rows[keep], minlength=n_rows)[:, None]
    mag = np.stack([np.bincount(rows[keep], weights=flat[:, j],
                                minlength=n_rows)
                    for j in range(flat.shape[1])], axis=1)
    return (2 * np.maximum(k - 1, 0) * 2.0**-24 * mag).reshape(
        (n_rows, *values.shape[1:]))


def _warp_slots(total: int):
    """The privatized path's warp slots in order, as (run, element
    indices of the 32 lanes, -1 past the end): runs of 128 elements, 4 a
    thread strided by 32, slot j holding elements 32 j .. 32 j + 31."""
    t = np.arange(32)
    for r, base in enumerate(range(0, total, RUN)):
        for j in range(4):
            e = base + 32 * j + t
            yield r, np.where(e < total, e, -1)


def _emulate_k4(values: np.ndarray, rows: np.ndarray, n_rows: int,
                plan, n_clusters: int = 3) -> np.ndarray:
    """The kernel along ``plan``, warp slot by warp slot in its order
    (``_warp_slots``): runs dealt to the blocks in turn, a slot whose 32
    elements share one word summed first and added once."""
    m = len(rows)
    inner = int(np.prod(values.shape[1:], dtype=np.int64))
    words = n_rows * inner
    flat = values.reshape(-1)
    dt = values.dtype
    out = np.zeros(words, dt)
    e = np.arange(m * inner)
    lane = e // max(inner, 1)
    r = rows[lane] if m else np.zeros(0, np.int32)
    w = np.where((r >= 0) & (r < n_rows), r.astype(np.int64) * inner
                 + e - lane * inner, -1)
    if plan.cluster == 0:
        keep = w >= 0
        np.add.at(out, w[keep], flat[keep])
        return out.reshape((n_rows, *values.shape[1:]))
    n_blocks = n_clusters * plan.cluster
    hist = np.zeros((n_blocks, plan.cluster * plan.chunk), dt)
    for run, e in _warp_slots(m * inner):
        b = run % n_blocks
        slot = np.where(e >= 0, w[np.maximum(e, 0)], -1)
        vals = np.where(e >= 0, flat[np.maximum(e, 0)], 0).astype(dt)
        if np.all(slot == slot[0]):
            if slot[0] >= 0:
                np.add.at(hist[b], slot[:1], vals.sum(dtype=dt,
                                                      keepdims=True))
        else:
            keep = slot >= 0
            np.add.at(hist[b], slot[keep], vals[keep])
    for c in range(n_clusters):
        summed = hist[c * plan.cluster:(c + 1) * plan.cluster].sum(
            axis=0, dtype=dt)
        for lo, hi in plan.block_words(words):
            nz = np.nonzero(summed[lo:hi])[0] + lo
            out[nz] += summed[nz]
    return out.reshape((n_rows, *values.shape[1:]))


def test_k4_path_from_shapes():
    """The smoke's shapes: Presence's game fan-in, one silo's half of it,
    collection's games, the routing sample's 256 sinks and hot sink and
    GPSTracker's notifiers privatized; Chirper's followers and
    publishers, chat's rooms, TwitterSentiment's hashtags and banking's
    accounts direct."""
    cap_g = 1 << 15
    for m, n_rows in ((1_000_000, cap_g), (500_000, cap_g),
                      (500_000, 1 << 14), (1_048_576, 1024),
                      (200_000, 1024)):
        plan = seg_plan(m, n_rows, 1, torch.float32)
        assert plan.cluster == segment.SEG_CLUSTER, (m, n_rows)
        assert plan.cluster * plan.chunk >= n_rows
        assert plan.chunk % 4 == 0
        assert 4 * plan.cluster * plan.chunk <= segment.SEG_BLOCK_BYTES \
            + 16 * plan.cluster
    for m, n_rows in ((2_011_069, 1 << 18), (200_000, 1 << 18),
                      (4096, 4096), (100_000, cap_g), (32_768, 65_536)):
        assert seg_plan(m, n_rows, 1, torch.int32).cluster == 0, (m, n_rows)


def test_k4_plan_thresholds():
    """At the edge of each threshold: elements per word, the output's
    bytes, an empty output or input."""
    per = segment.SEG_MIN_PER_WORD
    assert seg_plan(per * 100, 100).cluster
    assert seg_plan(per * 100 - 1, 100).cluster == 0
    words = segment.SEG_BLOCK_BYTES // 4
    assert seg_plan(per * words, words, 1, torch.float32).cluster
    assert seg_plan(per * (words + 1), words + 1, 1,
                    torch.float32).cluster == 0
    assert seg_plan(per * words, words // 4, 4).cluster
    assert seg_plan(per * words, words // 2, 4).cluster == 0
    assert seg_plan(per * 100, 100, 4).cluster   # inner counts elements
    assert seg_plan(per * 100 - 1, 100, 4).cluster == 0
    assert seg_plan(0, 100).cluster == 0
    assert seg_plan(10**6, 0).cluster == 0
    assert seg_plan(10**6, 1) == seg_plan(10**7, 1)   # from shapes alone


@pytest.mark.parametrize("words", [1, 3, 4, 5, 255, 1024, 10_001, 32_768])
def test_k4_cluster_split_covers_each_word_once(words):
    plan = seg_plan(segment.SEG_MIN_PER_WORD * words, words)
    assert plan.cluster and plan.chunk % 4 == 0
    assert 0 <= plan.cluster * plan.chunk - words < 4 * plan.cluster
    hit = np.zeros(words, np.int64)
    for lo, hi in plan.block_words(words):
        assert hi - lo <= plan.chunk
        hit[lo:hi] += 1
    np.testing.assert_array_equal(hit, 1)


def _k4_case(kind, dtype, rng):
    """(values, rows, n_rows) of each case."""
    n_rows, m, inner = {"uniform": (100, 5000, 1), "one_row": (1, 3000, 1),
                        "hot": (64, 4000, 1), "inner": (50, 2000, 3),
                        "empty_input": (40, 0, 1),
                        "empty_output": (0, 500, 1)}[kind]
    rows = rng.integers(0, max(n_rows, 1), m).astype(np.int32)
    if kind == "hot":
        rows[:3000] = 17   # whole warps on one word
    bad = rng.random(m) < 0.1
    rows[bad] = rng.choice(np.array([-1, n_rows, n_rows + 5, 2**31 - 1,
                                     -2**31], np.int32), bad.sum())
    shape = (m,) if inner == 1 else (m, inner)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32) \
        if dtype == np.int32 else rng.standard_normal(shape).astype(
            np.float32)
    return vals, rows, n_rows


K4_KINDS = ["uniform", "one_row", "hot", "inner", "empty_input",
            "empty_output"]
K4_PATHS = ["planned", "cluster", "alone", "direct"]


@pytest.mark.parametrize("path", K4_PATHS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("kind", K4_KINDS)
def test_k4_emulation_equals_plain_and_jax(kind, dtype, path):
    """Each path emulated (the planned one; clusters of 8; every block
    flushing alone; direct) against ``seg_sum_plain`` and JAX's
    ``seg_sum``: int32 (full-range values, so sums wrap) exactly, float32
    within twice Higham's bound."""
    rng = np.random.default_rng(
        [K4_KINDS.index(kind), K4_PATHS.index(path)])
    vals, rows, n_rows = _k4_case(kind, dtype, rng)
    inner = int(np.prod(vals.shape[1:], dtype=np.int64))
    words = n_rows * inner
    plan = seg_plan(len(rows), n_rows, inner, torch.from_numpy(vals).dtype)
    if path == "cluster":
        plan = segment.SegPlan(8, -(-max(words, 1) // 32) * 4, 1024, 1)
    elif path == "alone":
        plan = segment.SegPlan(1, -(-max(words, 1) // 4) * 4, 256, 4)
    elif path == "direct":
        plan = segment.SegPlan(0, 0, 256, 8)
    got = _emulate_k4(vals, rows, n_rows, plan)
    plain = segment.seg_sum_plain(torch.from_numpy(vals),
                                  torch.from_numpy(rows), n_rows).numpy()
    want = np.asarray(jax_seg_sum(jnp.asarray(vals), jnp.asarray(rows),
                                  n_rows))
    assert got.shape == plain.shape == want.shape
    if dtype == np.int32:
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, want)
    else:
        tol = _fan_in_tol(vals, rows, n_rows)
        assert np.all(np.abs(got.astype(np.float64) - plain) <= tol)
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


def test_k4_wrapper_takes_plain_on_cpu():
    before = segment.seg_sum.launches
    rng = np.random.default_rng(3)
    vals, rows, n_rows = _k4_case("uniform", np.int32, rng)
    got = segment.seg_sum(torch.from_numpy(vals), torch.from_numpy(rows),
                          n_rows)
    assert torch.equal(got, segment.seg_sum_plain(
        torch.from_numpy(vals), torch.from_numpy(rows), n_rows))
    assert segment.seg_sum.launches == before


# -- K8 ----------------------------------------------------------------------

def _emulate_k8(acc: np.ndarray, delta: np.ndarray, k: int, split) -> None:
    """The kernel's walk of one array along ``split``, in place: scalar
    head and tail, 16-byte groups touched only where their delta is
    nonzero; uint32 multiply-add."""
    a = acc.view(np.uint32)
    d = delta.view(np.uint32)
    ku = np.uint32(k & 0xFFFFFFFF)
    n = len(a)
    scalar = np.r_[0:split.head, n - split.tail:n].astype(np.int64)
    scalar = scalar[d[scalar] != 0]
    a[scalar] = a[scalar] + ku * d[scalar]
    g0 = split.head
    for g in range(split.groups):
        sl = slice(g0 + 4 * g, g0 + 4 * g + 4)
        if d[sl].any():
            a[sl] = a[sl] + ku * d[sl]


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 64, 1001])
@pytest.mark.parametrize("acc_off,delta_off", [(0, 0), (1, 1), (3, 3),
                                               (2, 2), (0, 1), (3, 2)])
def test_k8_split_covers_each_word_once(n, acc_off, delta_off):
    """Base addresses 16-byte aligned plus a word offset: co-aligned
    arrays take groups of 4 that start on a 16-byte boundary, others go
    word by word."""
    split = attr.apply_split(n, 4096 + 4 * acc_off, 8192 + 4 * delta_off)
    assert split.head + 4 * split.groups + split.tail == n
    if acc_off != delta_off:
        assert split == attr.ApplySplit(n, 0, 0)
    else:
        assert split.head <= 3 and split.tail <= 3
        if split.groups:
            assert (8192 + 4 * (delta_off + split.head)) % 16 == 0


@pytest.mark.parametrize("k", [0, 1, 16, 2**31 - 1, -3])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 2)])
def test_k8_emulation_equals_plain_and_jax(k, offsets):
    """A counts column and a sketch of odd lengths at word offsets (an
    unaligned head, a tail, a length that is no multiple of 4), deltas of
    full-range int32 with rows of zeros, so k·delta wraps; against
    ``attr_apply_plain`` and JAX ``_apply_coalesced``."""
    rng = np.random.default_rng(abs(k) % 97 + 7 * offsets[0])
    cap, depth, width = 1001, 3, 16
    counts = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    cms = rng.integers(-2**31, 2**31, (depth, width)).astype(np.int32)
    cdelta = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    cdelta[rng.random(cap) < 0.5] = 0
    cdelta[100:300] = 0   # whole groups untouched
    sdelta = rng.integers(-9, 9, (depth, width)).astype(np.int32)
    slots = rng.integers(0, 50, 8).astype(np.int32)
    n = np.array([12345], np.int32)
    acc_off, delta_off = offsets
    got_c, got_s = counts.copy(), cms.copy()
    for acc, delta in ((got_c, cdelta), (got_s.reshape(-1),
                                         sdelta.reshape(-1))):
        split = attr.apply_split(len(acc), 4096 + 4 * acc_off,
                                 8192 + 4 * delta_off)
        _emulate_k8(acc, delta, k, split)
    got_t = slots.copy()
    got_t[3] = np.int32((int(got_t[3]) + k * int(n[0]) + 2**31) % 2**32
                        - 2**31)
    want = [torch.from_numpy(x.copy()) for x in (counts, cms, slots)]
    attr.attr_apply_plain(want[0], torch.from_numpy(cdelta), want[1],
                          torch.from_numpy(sdelta), k, total=want[2],
                          slot=3, n=torch.from_numpy(n))
    jk = np.int32(np.int64(k).astype(np.int32))
    jwant = jattr._apply_coalesced(
        jnp.asarray(counts), jnp.asarray(cms), jnp.asarray(slots),
        jnp.asarray(cdelta), jnp.asarray(sdelta), jnp.int32(3),
        jnp.int32(n[0]), jnp.int32(jk))
    for g, w, jw in zip((got_c, got_s, got_t), want, jwant):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(jw))


def test_k8_plan_shares_the_grid():
    """One 16-byte group a thread where the grid allows; else the
    persistent grid shared by the two ranges in proportion, each range
    with a word keeping a block; a small flush in thinner blocks, eager."""
    big = attr.ApplySplit(0, 524_288, 0)      # PresenceGrain's counts
    sketch = attr.ApplySplit(0, 8192, 0)      # a 4x8192 sketch
    game = attr.ApplySplit(0, 8192, 0)        # GameGrain's counts
    cap = 132 * attr.APPLY_BLOCKS_PER_SM
    plan = attr.apply_plan(big, sketch, 132)
    assert plan.blocks_c + plan.blocks_s <= cap and plan.blocks_s >= 1
    assert plan.blocks_c > 30 * plan.blocks_s
    assert plan.threads == attr.APPLY_THREADS and not plan.eager
    plan = attr.apply_plan(game, sketch, 132)
    assert plan.threads == attr.APPLY_MIN_THREADS and plan.eager
    assert plan.blocks_c == plan.blocks_s == 8192 // plan.threads
    empty = attr.ApplySplit(0, 0, 0)
    plan = attr.apply_plan(attr.ApplySplit(3, 0, 0), empty, 132)
    assert (plan.blocks_c, plan.blocks_s) == (1, 0)
    plan = attr.apply_plan(empty, empty, 132)
    assert (plan.blocks_c, plan.blocks_s) == (0, 0)
    plan = attr.apply_plan(big, attr.ApplySplit(2, 0, 1), 132)
    assert plan.blocks_s == 1 and plan.blocks_c + plan.blocks_s <= cap
