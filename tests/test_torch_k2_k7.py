"""The shape-side plans of K2 ``resolve_sorted`` and K7 ``attr_fold``, on
the CPU: what the CUDA kernels compute from the plans is emulated in numpy
and held against the plain answer.

* K2: the wrapper's ``resolve_plan`` (a whole-mirror tree of at most 4,095
  keys, or splitters every ``2**log_s`` keys with buckets searched in L2)
  drives an emulation of the kernel's Eytzinger descent, sub-bucket
  lifting and final run of 8 keys; its lower bound and the key found there
  equal ``np.searchsorted``'s over mirror sizes on both sides of the tree.
* K7: ``fold_plan`` picks the path from shapes alone; the cluster's split
  of the histogram's words covers each word once; an emulation of the
  cluster path (each block's own histogram, then block ``r`` summing
  chunk ``r`` of the cluster's copies) equals the plain fold.
"""

import numpy as np
import pytest
import torch

from orleans_tpu_torch.kernels import attr
from orleans_tpu_torch.kernels.resolve import (KEY_SENTINEL, TREE_LEVELS,
                                               resolve_plan)

INF = 2**31 - 1
SEEDS = (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)


def _emulate_k2(sk: np.ndarray, keys: np.ndarray):
    """The kernel's search, lane-vectorized: (lower bound, key there)."""
    n = len(sk)
    whole, levels, log_s, _ = resolve_plan(n)
    sk64, k = sk.astype(np.int64), keys.astype(np.int64)
    j = np.arange((1 << levels) - 1, dtype=np.int64)
    src = j if whole else (j + 1) << log_s
    val = np.where(src < n, sk64[np.minimum(src, n - 1)], INF)
    t = np.log2((j + 1) & -(j + 1)).astype(np.int64)  # trailing zeros
    tree = np.zeros(1 << levels, np.int64)
    tree[(1 << (levels - 1 - t)) + ((j + 1) >> (t + 1))] = val
    node = np.ones(len(k), np.int64)
    upper = np.full(len(k), INF, np.int64)
    for _ in range(levels):
        v = tree[node]
        lt = v < k
        upper = np.where(lt, upper, v)
        node = 2 * node + lt
    b = node - (1 << levels)
    if whole:
        return b, upper

    def at(i):
        return np.where(i < n, sk64[np.minimum(i, n - 1)], INF)

    pos = b << log_s
    step = (1 << log_s) >> 1
    while step >= 8:
        v = at(pos + step)
        lt = v < k
        pos = np.where(lt, pos + step, pos)
        upper = np.where(lt, upper, v)
        step >>= 1
    vals = at(pos[:, None] + np.arange(8))
    lt = vals < k[:, None]
    upper = np.minimum(upper, np.where(lt, INF, vals).min(axis=1))
    return pos + lt.sum(axis=1), upper


@pytest.mark.parametrize("fill", ["half", "empty", "full"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 32768, 524288])
def test_k2_two_level_search_equals_searchsorted(n, fill):
    rng = np.random.default_rng(n)
    live = {"half": n // 2, "empty": 0, "full": n}[fill]
    sk = np.full(n, KEY_SENTINEL, np.int64)
    sk[:live] = np.sort(rng.choice(2**32 - 1, live, replace=False)) - 2**31
    sk = sk.astype(np.int32)
    keys = rng.integers(-2**31, 2**31, 4000, dtype=np.int64)
    if live:
        keys[:1000] = sk[rng.integers(0, live, 1000)]
        keys[1000:1100] = int(sk[live - 1]) + 1
    keys[1100:1200] = -2**31
    keys[1200:1300] = KEY_SENTINEL
    keys = keys.astype(np.int32)
    idx, key_at = _emulate_k2(sk, keys)
    want = np.searchsorted(sk, keys, side="left")
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(
        key_at, np.where(want < n, sk[np.minimum(want, n - 1)], INF))


def test_k2_plan_bounds_the_tree():
    """At most 2**TREE_LEVELS - 1 nodes (16 KB); buckets of at least 8
    keys that, 2**levels of them, cover the mirror."""
    for n in [1, 2, 3, 4095, 4096, 4097, 32768, 32769, 524288, 1 << 24]:
        whole, levels, log_s, per_sm = resolve_plan(n)
        assert 1 <= levels <= TREE_LEVELS and per_sm >= 1
        if whole:
            assert n <= (1 << levels) - 1 and log_s == 0
        else:
            assert log_s >= 3 and (1 << (levels + log_s)) >= n
    assert resolve_plan(32768)[:3] == (False, 12, 3)
    assert resolve_plan(524288)[:3] == (False, 12, 7)


def test_k7_path_from_shapes():
    """The Presence shapes keep direct counts atomics; GameGrain's counts
    and the 4x8192 sketch take the cluster's histograms, and the sketch
    when both do not fit a block."""
    m, cap_p, cap_g = 1_000_000, 1 << 21, 1 << 15
    plan = attr.fold_plan(m, cap_p, 0, 1, False)
    assert plan.cluster == 0
    plan = attr.fold_plan(m, cap_g, 0, 1, False)
    assert plan.cluster == attr.FOLD_CLUSTER and plan.hist_counts
    plan = attr.fold_plan(m, cap_p, 4, 8192, False)
    assert plan.cluster and plan.hist_cms and not plan.hist_counts
    plan = attr.fold_plan(m, cap_g, 4, 8192, False)  # 256 KB: the sketch
    assert plan.cluster and plan.hist_cms and not plan.hist_counts
    plan = attr.fold_plan(m, 20_000, 2, 4096, False)
    assert plan.cluster and plan.hist_cms and plan.hist_counts
    plan = attr.fold_plan(cap_p, cap_p, 4, 8192, True)
    assert plan.cluster and plan.hist_cms and not plan.hist_counts
    assert attr.fold_plan(cap_g, cap_g, 4, 8192, True).cluster == 0
    assert attr.fold_plan(0, 64, 4, 16, False).cluster == 0


@pytest.mark.parametrize("m,cap,depth,width,weighted", [
    (1_000_000, 1 << 15, 4, 8192, False), (1_000_000, 1 << 15, 0, 1, False),
    (16_016, 1001, 4, 16, False), (16_016, 1001, 0, 1, False),
    (1 << 21, 1 << 21, 4, 8192, True), (1001, 1001, 3, 16, True),
    (1_000_000, 20_000, 2, 4096, False)])
def test_k7_cluster_split_covers_each_word_once(m, cap, depth, width,
                                                weighted):
    plan = attr.fold_plan(m, cap, depth, width, weighted)
    assert plan.cluster and plan.chunk % 4 == 0
    words = cap * plan.hist_counts + depth * width * plan.hist_cms
    assert 4 * words <= attr.FOLD_BLOCK_BYTES
    assert 0 <= plan.cluster * plan.chunk - words < 4 * plan.cluster
    hit = np.zeros(words, np.int64)
    for lo, hi in plan.block_words(cap, depth, width):
        assert hi - lo <= plan.chunk
        hit[lo:hi] += 1
    np.testing.assert_array_equal(hit, 1)
    assert len(plan.block_words(cap, depth, width)) == plan.cluster


@pytest.mark.parametrize("weighted", [False, True])
def test_k7_cluster_fold_equals_plain(weighted):
    """The cluster path emulated: 3 clusters of blocks, each block folding
    its share of the lanes into its own histogram, then block ``r`` of a
    cluster adding the sum of the cluster's words ``block_words()[r]``
    into the accumulators; equal to the plain fold."""
    rng = np.random.default_rng(7)
    cap, depth, width = 1001, 4, 16
    m = cap if weighted else 16 * cap
    rows = rng.integers(-3, cap + 3, m).astype(np.int32)
    rows[:5] = -2**31
    valid = rng.random(m) < 0.9
    weight = rng.integers(-3, 5, cap).astype(np.int32)
    plan = attr.fold_plan(m, cap, depth, width, weighted)
    assert plan.cluster
    counts0 = rng.integers(0, 9, cap).astype(np.int32)
    cms0 = rng.integers(0, 9, (depth, width)).astype(np.int32)
    if weighted:
        r, inc = np.arange(cap), weight.astype(np.int64)
    else:
        ok = valid & (rows >= 0) & (rows < cap)
        r, inc = rows[ok].astype(np.int64), np.ones(ok.sum(), np.int64)
    h = attr.cms_hash(torch.from_numpy(r.astype(np.int32)), SEEDS[:depth],
                      width).numpy().astype(np.int64)
    n_blocks = 3 * plan.cluster
    block = np.arange(len(r)) % n_blocks
    hist = np.zeros((n_blocks, plan.cluster * plan.chunk), np.int64)
    counts, cms = counts0.astype(np.int64), cms0.astype(np.int64)
    if plan.hist_counts:
        np.add.at(hist, (block, r), inc)
    else:
        np.add.at(counts, r, inc)
    cms_word = cap if plan.hist_counts else 0
    for d in range(depth):
        w = d * width + h[d]
        if plan.hist_cms:
            np.add.at(hist, (block, cms_word + w), inc)
        else:
            np.add.at(cms.reshape(-1), w, inc)
    for c in range(3):
        summed = hist[c * plan.cluster:(c + 1) * plan.cluster].sum(axis=0)
        for lo, hi in plan.block_words(cap, depth, width):
            for wd in range(lo, hi):
                if wd < cms_word:
                    counts[wd] += summed[wd]
                else:
                    cms.reshape(-1)[wd - cms_word] += summed[wd]
    want_c, want_s = torch.from_numpy(counts0), torch.from_numpy(cms0)
    if weighted:
        attr.attr_fold_plain(want_c, want_s, SEEDS, weight=torch.from_numpy(
            weight))
    else:
        attr.attr_fold_plain(want_c, want_s, SEEDS, torch.from_numpy(rows),
                             torch.from_numpy(valid))
    np.testing.assert_array_equal(counts.astype(np.int32), want_c.numpy())
    np.testing.assert_array_equal(cms.astype(np.int32), want_s.numpy())
