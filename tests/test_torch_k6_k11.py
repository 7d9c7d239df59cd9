"""K6 ``miss_keys`` and K11 ``fanout_expand`` on the CPU: what the CUDA
kernels compute is emulated in numpy, step by step as the kernels take it,
and held against the plain versions and the JAX functions
(``_miss_keys_kernel``, ``_expand_kernel``).

* K11's lane pass: the lower bound of each source key from splitters
  (every ``step``-th graph key) and a short run of the graph's keys; the
  degrees scanned a tile at a time, each tile's aggregate (its sum mod
  2**32 and the wrap bit: a negative degree or an exact sum past
  2**31 - 1), the exclusive prefix of each tile found by walking back over
  its predecessors 32 at a time, where each may show its aggregate or its
  inclusive prefix; the drop flags, the total, the wrap flag and the first
  owner of every slot tile.
* K11's slot pass: with offs monotone, each slot tile's windows of owner
  lanes from its first owner to the next tile's, each group of 4 slots
  owned by a search over the window and another where the owner changes;
  under the wrap bit, the per-slot bisection of JAX's
  ``jnp.searchsorted`` (a fixed number of halvings from ``(0, m)``), whose
  answer on a non-monotone scan is the reference's.
* K6's mark: 4 lanes a thread 32 apart, a warp's missing lanes that share
  a key electing their lowest lane, the leader reading its slot before
  claiming an empty one (linear probing over the kernel's hash); blocks
  appending their claimed keys in any order; the emit clearing exactly
  the slots it used, so the table is all sentinel again.
* K6's sort chosen by the count of unique keys: tiles sorted each by a
  bitonic network over one key a thread, a key's rank its index in its
  tile plus its lower bound in every other tile; above the limit
  an LSD radix sort of the order-mapped keys, 8 bits a pass, each block's
  chunk scattered a sub-tile at a time with ranks by warp, by digit
  prefix over the warps and by the running digit offset.

The cases are the hazards of the kernels: a wrapping scan, m = 0, the
empty graph, one source of 200,000 edges, more unique misses than
``miss_buf``, all-duplicate keys, negative and sentinel keys.  Every value
compared is an integer: the comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.tensor.engine import _miss_keys_kernel
from orleans_tpu.tensor.fanout import _expand_kernel

from orleans_tpu_torch.kernels import fanout as kfan
from orleans_tpu_torch.kernels import miss as kmiss
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL

SENTINEL = KEY_SENTINEL
INT32_TOP = 2**31 - 1


def _wrap32(x):
    """int64 values mod 2**32, read as int32."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int64)


# -- K11: the lane pass --------------------------------------------------------

def _lower_bound(keys, key, lo, length):
    while length > 0:
        half = length >> 1
        if keys[lo + half] < key:
            lo += half + 1
            length -= half + 1
        else:
            length = half
    return lo


def emulate_search(csr_keys, src_keys, splitters=256):
    """Each lane's lower bound in the graph's keys: first over the
    splitters ``csr_keys[q * step]`` (a branchless lower bound, in shared
    memory on the card), then by bisection over the at most ``step - 1``
    keys it leaves."""
    n_src = len(csr_keys)
    step = -(-n_src // splitters)
    spl = csr_keys[::step]
    n_spl = len(spl)
    out = np.empty(len(src_keys), np.int64)
    for i, key in enumerate(src_keys):
        a, n = 0, n_spl
        while n > 1:
            half = n >> 1
            a = a + half if spl[a + half] < key else a
            n -= half
        a += int(spl[a] < key)
        lo = (a - 1) * step + 1 if a > 0 else 0
        hi = a * step if a < n_spl else n_src
        out[i] = _lower_bound(csr_keys, key, lo, hi - lo)
    return out


def _combine(a, b):
    """Two (wrap, sum mod 2**32) scans joined."""
    s = a[1] + b[1]
    return (a[0] or b[0] or s > INT32_TOP, s % 2**32)


def emulate_lane_pass(csr_keys, csr_offsets, src_keys, valid, width, rng,
                      lane_tile=1024, slot_tile=1024, splitters=256):
    """The lane pass's outputs: (start, offs, src_dropped, n_dropped,
    total, wrapped, tile_owner)."""
    m, n_src = len(src_keys), len(csr_keys)
    lb = emulate_search(csr_keys, src_keys, splitters)
    idx = np.minimum(lb, n_src - 1)
    hit = valid & (csr_keys[idx] == src_keys)
    s0 = np.where(hit, csr_offsets[idx], 0).astype(np.int64)
    deg = np.where(hit, _wrap32(csr_offsets[np.minimum(idx + 1, n_src)]
                                - csr_offsets[idx]), 0)
    n_tiles = -(-m // lane_tile)
    aggregates = []
    for t in range(n_tiles):
        d = deg[t * lane_tile:(t + 1) * lane_tile]
        u = d % 2**32  # the kernel's uint32 degrees
        aggregates.append((bool((d < 0).any() or u.sum() > INT32_TOP),
                           int(u.sum()) % 2**32))
    # the look-back: a predecessor shows its aggregate or, when it has got
    # that far, its inclusive prefix; the walk stops at the nearest prefix
    inclusive = []
    exclusive = []
    def shown(p):
        if p < 0:
            return ("prefix", (False, 0))
        if p == 0 or rng.random() < 0.5:
            return ("prefix", inclusive[p])
        return ("aggregate", aggregates[p])

    for t in range(n_tiles):
        wrap, total = False, 0
        base = t - 1
        while base >= 0:
            window = [shown(p) for p in range(base, base - 32, -1)]
            stop = next((k for k, w in enumerate(window)
                         if w[0] == "prefix"), 31)
            for w in window[:stop + 1]:
                wrap |= w[1][0]
                total += w[1][1]
            if any(w[0] == "prefix" for w in window):
                break
            base -= 32
        excl = (wrap or total > INT32_TOP, total % 2**32)
        exclusive.append(excl)
        inclusive.append(_combine(excl, aggregates[t]))
    offs = np.empty(m, np.int64)
    for t in range(n_tiles):
        lo, hi = t * lane_tile, min(m, (t + 1) * lane_tile)
        offs[lo:hi] = _wrap32(exclusive[t][1]
                              + np.cumsum(deg[lo:hi] % 2**32))
    src_dropped = (deg > 0) & (offs > width)
    n_slot_tiles = -(-width // slot_tile) if width > 0 else 0
    tile_owner = np.full(n_slot_tiles, -1, np.int64)
    for i in np.nonzero(deg > 0)[0]:
        incl = int(offs[i])
        excl = int(_wrap32(incl - deg[i]))
        if excl < 0 or incl <= excl:
            continue
        for k in range(-(-excl // slot_tile),
                       min((incl - 1) // slot_tile, n_slot_tiles - 1) + 1):
            tile_owner[k] = i
    return (s0, offs, src_dropped, int(src_dropped.sum()), int(offs[-1]),
            bool(inclusive[-1][0]), tile_owner)


# -- K11: the slot pass --------------------------------------------------------

def _slot_by_search(j, offs, start, csr_dst, width, total):
    """One slot under the wrap bit: the reference's fixed-depth bisection
    (``ceil(log2(m + 1))`` steps from ``(0, m)``, ``mid`` the floored
    mean, left where ``j < offs[mid]``, the answer ``high``), clipped."""
    m = len(offs)
    low, high = 0, m
    for _ in range(m.bit_length()):
        mid = (low + high) // 2
        if j < offs[mid]:
            high = mid
        else:
            low = mid
    src = min(high, m - 1)
    before = offs[src - 1] if src > 0 else 0
    e = int(_wrap32(start[src] + j - before))
    ok = j < total and offs[src] <= width
    return (csr_dst[min(max(e, 0), width - 1)] if ok else SENTINEL, src, ok)


def emulate_slot_pass(lane, csr_dst, width, slot_tile=1024, window=2048):
    """(dst, src_index, out_valid) as the slot pass writes them, tile by
    tile, and the window rounds each live tile took.  Within a round, each
    group of 4 slots (vectorized here) finds its first owner by a search
    over the window, and its other slots search on from there when the
    owner changes."""
    start, offs, _, _, total, wrapped, tile_owner = lane
    m = len(offs)
    dst = np.full(width, -7, np.int64)
    src_index = np.full(width, -7, np.int64)
    out_valid = np.zeros(width, bool)
    rounds = []
    for k in range(-(-width // slot_tile) if width > 0 else 0):
        j0, j_end = k * slot_tile, min((k + 1) * slot_tile, width)
        if wrapped:
            for j in range(j0, j_end):
                dst[j], src_index[j], out_valid[j] = _slot_by_search(
                    j, offs, start, csr_dst, width, total)
            continue
        j_live = min(j_end, max(total, j0))
        dst[j0:j_end], src_index[j0:j_end] = SENTINEL, m - 1
        out_valid[j0:j_end] = False
        if j0 >= j_live:
            continue
        c0 = int(tile_owner[k])
        assert c0 >= 0, "a live slot tile without a first owner"
        # the window runs to the next tile's first owner
        nxt = k + 1
        c_last = int(tile_owner[nxt]) if nxt < len(tile_owner) \
            and nxt * slot_tile < total else m - 1
        n_rounds = 0
        groups = np.arange(j0, j_end, 4)
        while True:
            n_rounds += 1
            c1 = min(c0 + window, c_last + 1)
            ends, starts = offs[c0:c1], start[c0:c1]
            base = offs[c0 - 1] if c0 > 0 else 0
            covered = ends[-1]
            g = groups[(groups + 3 >= base) & (groups < j_live)
                       & (groups < covered)]
            q = np.searchsorted(ends, np.maximum(g, base), "right")
            for e in range(4):
                j = g + e
                keep = (j >= base) & (j < j_live) & (j < covered)
                j, qe = j[keep], q[keep]
                # past the group's first owner: the next owner searched
                # from there on (over any zero-degree lanes)
                step = ends[np.minimum(qe, len(ends) - 1)] <= j
                qe = np.where(step, np.searchsorted(ends, j, "right"), qe)
                before = np.where(qe > 0, ends[np.maximum(qe - 1, 0)], base)
                edge = _wrap32(starts[qe] + j - before)
                ok = ends[qe] <= width
                dst[j] = np.where(ok, csr_dst[np.clip(edge, 0, width - 1)],
                                  SENTINEL)
                src_index[j], out_valid[j] = c0 + qe, ok
            if covered >= j_live or c1 > c_last:
                break
            c0 = c1
        rounds.append(n_rounds)
    return dst, src_index, out_valid, rounds


def emulate_fanout(csr_keys, csr_offsets, csr_dst, src_keys, valid, seed=0,
                   **plan):
    """The six outputs of ``fanout_expand`` as the two launches compute
    them, and the slot tiles' window rounds."""
    csr_keys, csr_offsets, csr_dst = (np.asarray(a, np.int64) for a in
                                      (csr_keys, csr_offsets, csr_dst))
    src_keys = np.asarray(src_keys, np.int64)
    valid = np.asarray(valid, bool)
    width = len(csr_dst)
    rng = np.random.default_rng(seed)
    lane_plan = {k: v for k, v in plan.items()
                 if k in ("lane_tile", "slot_tile", "splitters")}
    lane = emulate_lane_pass(csr_keys, csr_offsets, src_keys, valid, width,
                             rng, **lane_plan)
    slot_plan = {k: v for k, v in plan.items()
                 if k in ("slot_tile", "window")}
    dst, src_index, out_valid, rounds = emulate_slot_pass(
        lane, csr_dst, width, **slot_plan)
    return (dst, src_index, out_valid, lane[4], lane[2], lane[3]), lane, \
        rounds


def _fanout_graph(case, rng):
    """(csr_keys, csr_offsets, csr_dst, src_keys, valid) of a case."""
    if case == "power_law_row":
        # one source of 200,000 edges among a power-law tail
        tail = np.minimum(rng.zipf(1.6, 3000), 400)
        deg = np.concatenate([[200_000], tail])
        keys = np.sort(rng.choice(50_000, len(deg), replace=False))
        offsets = np.concatenate([[0], np.cumsum(deg)])
        dst = rng.integers(0, 1 << 20, int(offsets[-1]) + 37)
        src = np.concatenate([keys[:1], rng.choice(keys, 900),
                              rng.integers(0, 50_000, 300)])
        rng.shuffle(src)
        valid = rng.random(len(src)) < 0.97
    elif case == "wrap":
        # three sources of 2**30 edges: the int32 scan wraps, offs is not
        # monotone, the slot pass takes the per-slot search
        keys = np.array([3, 8, 11, 20])
        offsets = np.array([0, 5, 2**30 + 5, 2**31 - 9, 2**31 - 2])
        dst = rng.integers(0, 1000, 300)
        src = np.array([3, 8, 8, 20, 11, 8, 3, 8, 99, 11] * 30)
        valid = rng.random(len(src)) < 0.9
    elif case == "empty_graph":
        keys, offsets = np.array([SENTINEL]), np.zeros(2, np.int64)
        dst = np.full(256, SENTINEL)
        src = np.array([0, 3, SENTINEL] * 5)
        valid = np.ones(len(src), bool)
    elif case == "crowded_windows":
        # most lanes without edges: a slot tile's owners spread over more
        # lanes than one window holds
        keys = np.arange(0, 4000, 2)
        deg = rng.integers(1, 4, len(keys))
        offsets = np.concatenate([[0], np.cumsum(deg)])
        dst = rng.integers(0, 1000, int(offsets[-1]) + 5)
        src = rng.integers(0, 4000, 30_000)
        src[rng.random(len(src)) < 0.97] = 1  # no such source: degree 0
        valid = np.ones(len(src), bool)
    else:  # "overflow": duplicate sources need more slots than the width
        keys = np.array([1, 2, 5])
        offsets = np.array([0, 300, 301, 350])
        dst = rng.integers(0, 1000, 600)
        src = np.array([1, 2, 1, 5, 1, 7, 2, 5] * 4)
        valid = np.ones(len(src), bool)
    return (keys.astype(np.int32), offsets.astype(np.int32),
            dst.astype(np.int32), src.astype(np.int32), valid)


def _plain_fanout(args):
    out = kfan.fanout_expand_plain(*(torch.from_numpy(np.asarray(a))
                                     for a in args))
    return [np.asarray(o.numpy(), np.int64) for o in out]


@pytest.mark.parametrize("case", ["power_law_row", "wrap", "empty_graph",
                                  "crowded_windows", "overflow"])
def test_fanout_emulation_matches_plain(case):
    """The two launches emulated at the kernel's tiles (small windows and
    few splitters where the case needs several rounds or a longer run)
    equal the plain version, six outputs exactly."""
    rng = np.random.default_rng(len(case))
    args = _fanout_graph(case, rng)
    plan = dict(window=64, splitters=32) if case == "crowded_windows" \
        else {}
    got, lane, rounds = emulate_fanout(*args, **plan)
    want = _plain_fanout(args)
    for name, g, w in zip(("dst", "src_index", "out_valid", "total",
                           "src_dropped", "n_dropped"), got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64), w,
                                      err_msg=name)
    assert lane[5] == (case == "wrap")  # the device-side plan
    if case == "crowded_windows":
        assert max(rounds) > 1
    if case == "overflow":
        assert got[5] > 0


FANOUT_NAMES = ("dst", "src_index", "out_valid", "total", "src_dropped",
                "n_dropped")


@pytest.mark.parametrize("case", ["power_law_row", "wrap", "overflow"])
def test_fanout_emulation_matches_jax(case):
    """The emulation against JAX ``_expand_kernel`` (jitted on the CPU),
    six outputs exactly."""
    rng = np.random.default_rng(7 + len(case))
    args = _fanout_graph(case, rng)
    got, _, _ = emulate_fanout(*args)
    want = _expand_kernel(*(jnp.asarray(a) for a in args))
    for name, g, w in zip(FANOUT_NAMES, got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64), err_msg=name)


@pytest.mark.parametrize("case", ["graph", "witness", "wrap_back",
                                  "wrap_back_past_width"])
def test_fanout_wrap_matches_jax_src_index_included(case):
    """Under a wrapping scan all six outputs equal JAX's, ``src_index``
    included (the slot's owner by the reference's own bisection of a
    non-monotone offs), through the emulation and the plain version.
    The witness is a small one: five lanes, a width of 300.  The
    wrap-back cases' scans wrap twice and end on a positive total: four
    lanes of a source of 2**30 edges and one of 5 give offs 2**30,
    -2**31, -2**30, 0, 5, so the last lane owns the 5 live slots, which
    are valid and gather their destinations; five lanes of the source of
    2**30 give offs 2**30, -2**31, -2**30, 0, 2**30 and a total of 2**30,
    whose slots the bisection gives the last lane, past the width."""
    dst = np.random.default_rng(5).integers(0, 1000, 300).astype(np.int32)
    if case == "graph":
        args = _fanout_graph("wrap", np.random.default_rng(11))
    elif case == "witness":
        args = (np.array([3, 8, 11, 20], np.int32),
                np.array([0, 5, 2**30 + 5, 2**31 - 9, 2**31 - 2], np.int32),
                np.arange(300, dtype=np.int32),
                np.array([3, 20, 20, 11, 8], np.int32), np.ones(5, bool))
    elif case == "wrap_back":
        args = (np.array([3, 8], np.int32),
                np.array([0, 5, 2**30 + 5], np.int32), dst,
                np.array([8, 8, 8, 8, 3], np.int32), np.ones(5, bool))
    else:
        args = (np.array([3, 8], np.int32),
                np.array([0, 2**30, 2**30 + 5], np.int32), dst,
                np.full(5, 3, np.int32), np.ones(5, bool))
    got, lane, _ = emulate_fanout(*args)
    assert lane[5]  # the scan wrapped
    plain = _plain_fanout(args)
    want = _expand_kernel(*(jnp.asarray(a) for a in args))
    for name, g, p, w in zip(FANOUT_NAMES, got, plain, want):
        w = np.asarray(w, np.int64)
        np.testing.assert_array_equal(np.asarray(g, np.int64), w,
                                      err_msg=f"emulation {name}")
        np.testing.assert_array_equal(p, w, err_msg=f"plain {name}")
    if case == "wrap_back":
        assert int(want[3]) == 5
        np.testing.assert_array_equal(np.asarray(want[0])[:5], dst[:5])
        assert np.asarray(want[2]).sum() == 5
    if case == "wrap_back_past_width":
        assert int(want[3]) == 2**30 and not np.asarray(want[2]).any()


@pytest.mark.parametrize("lane_tile", [32, 256])
def test_look_back_is_independent_of_what_the_predecessors_show(lane_tile):
    """Whatever mix of aggregates and prefixes a tile's walk meets (tiles
    of 32 lanes give walks over several windows of 32 predecessors), the
    scan equals the one-tile scan and the outputs the plain version's."""
    rng = np.random.default_rng(lane_tile)
    args = _fanout_graph("crowded_windows", rng)
    want = _plain_fanout(args)
    _, one, _ = emulate_fanout(*args, lane_tile=1 << 20)
    for seed in range(2):
        got, lane, _ = emulate_fanout(*args, seed=seed, lane_tile=lane_tile)
        np.testing.assert_array_equal(lane[1], one[1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, np.int64), w)
        assert not lane[5]


def test_wrap_bit_follows_the_exact_prefix():
    """The wrap bit is set exactly when offs stops being monotone: two
    lanes whose ranges end at 2**31 - 1 keep the fast plan, one more edge
    wraps."""
    rng = np.random.default_rng(3)
    for extra, wraps in ((0, False), (1, True)):
        offsets = _wrap32(np.array([0, 2**30, 2**31 - 1 + extra]))
        args = (np.array([1, 2], np.int32), offsets.astype(np.int32),
                rng.integers(0, 9, 64).astype(np.int32),
                np.array([1, 2], np.int32), np.ones(2, bool))
        got, lane, _ = emulate_fanout(*args)
        assert lane[5] == wraps
        want = _plain_fanout(args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, np.int64), w)


def test_fanout_no_messages_and_wrapper():
    """m = 0 keeps its answer (every slot invalid, the wrapper's plain path
    on the CPU); the slot tiles' owners cover every live tile."""
    keys, offsets, dst, _, _ = _fanout_graph("overflow",
                                             np.random.default_rng(0))
    out = kfan.fanout_expand(*(torch.from_numpy(a) for a in
                               (keys, offsets, dst)),
                             torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.bool))
    assert out[2].sum() == 0 and int(out[3]) == 0 and out[4].numel() == 0
    assert (out[0] == SENTINEL).all()
    rng = np.random.default_rng(1)
    args = _fanout_graph("power_law_row", rng)
    _, lane, _ = emulate_fanout(*args, slot_tile=512)
    live = -(-min(lane[4], len(args[2])) // 512)
    assert (lane[6][:live] >= 0).all()
    assert kfan.LANE_TILE == 1024 and kfan.SLOT_TILE == 1024


# -- K6 --------------------------------------------------------------------------

def _slot_of(key, mask):
    h = (int(key) * 0x9E3779B1) & 0xFFFFFFFF
    h ^= h >> 16
    return h & mask


def emulate_mark(keys, rows, valid, p, rng, mark_lanes=1024):
    """The mark launch over a table of ``p`` slots, all the sentinel: the
    missing mask, the compact keys and slots (blocks appending in a random
    order), the table after, and the lanes that touched the table."""
    m = len(keys)
    miss = (rows < 0) & valid & (keys < SENTINEL)
    table = np.full(p, SENTINEL, np.int64)
    mask = p - 1
    leaders = 0
    rounds = list(range(-(-m // mark_lanes)))
    rng.shuffle(rounds)  # blocks run in any order
    uniq, slots = [], []
    for r in rounds:
        new = []
        for w0 in range(r * mark_lanes, min(m, (r + 1) * mark_lanes), 128):
            for k in range(4):
                lanes = np.arange(w0 + 32 * k, min(w0 + 32 * k + 32, m))
                seen = set()
                for i in lanes:
                    if not miss[i] or keys[i] in seen:
                        continue  # not missing, or not the lowest lane
                    seen.add(keys[i])
                    leaders += 1
                    s = _slot_of(keys[i], mask)
                    while table[s] != keys[i]:
                        if table[s] == SENTINEL:
                            table[s] = keys[i]
                            new.append((keys[i], s))
                            break
                        s = (s + 1) & mask
        for key, s in new:
            uniq.append(key)
            slots.append(s)
    return miss, np.array(uniq, np.int64), np.array(slots, np.int64), \
        table, leaders


def emulate_radix(keys, blocks, sort_threads=1024, radix_bits=8):
    """The LSD radix sort of the cooperative grid: per pass, each block's
    chunk counted, each digit's first place for each block from every
    block's counts, then the chunk scattered a sub-tile of
    ``sort_threads`` keys at a time (rank: digit offset + the warps before
    + the lower lanes of the warp with that digit)."""
    n = len(keys)
    src = np.asarray(keys, np.int64)
    radix = 1 << radix_bits
    for shift in range(0, 32, radix_bits):
        digit = (((src % 2**32) ^ 0x80000000) >> shift) & (radix - 1)
        chunk = -(-n // blocks)
        counts = np.zeros((radix, blocks), np.int64)
        for b in range(blocks):
            lo, hi = min(b * chunk, n), min(b * chunk + chunk, n)
            counts[:, b] = np.bincount(digit[lo:hi], minlength=radix)
        totals = counts.sum(1)
        dst = np.full(n, -1, np.int64)
        for b in range(blocks):
            lo, hi = min(b * chunk, n), min(b * chunk + chunk, n)
            offset = np.concatenate([[0], np.cumsum(totals)[:-1]]) \
                + counts[:, :b].sum(1)
            for t0 in range(lo, hi, sort_threads):
                d = digit[t0:min(hi, t0 + sort_threads)]
                warp_counts = np.zeros((sort_threads // 32, radix), np.int64)
                lane_rank = np.zeros(len(d), np.int64)
                for q, dq in enumerate(d):
                    w, lane = divmod(q, 32)
                    lane_rank[q] = np.sum(d[w * 32:q] == dq)
                    if lane_rank[q] == 0:
                        warp_counts[w, dq] = np.sum(d[w * 32:w * 32 + 32]
                                                    == dq)
                before = np.cumsum(warp_counts, 0) - warp_counts
                for q, dq in enumerate(d):
                    dst[offset[dq] + before[q // 32, dq] + lane_rank[q]] = \
                        src[t0 + q]
                offset += warp_counts.sum(0)
        assert (dst >= -2**31).all() and len(set(dst.tolist())) == n
        src = dst
    return src


def emulate_sort_block(v, length):
    """The block's bitonic network over one key a thread: partner i ^ j,
    the lower index keeping the min where the stage runs up."""
    v = v.copy()
    i = np.arange(len(v))
    k = 2
    while k <= length:
        j = k >> 1
        while j > 0:
            other = v[i ^ j]
            low, up = (i & j) == 0, (i & k) == 0
            v = np.where(low == up, np.minimum(v, other),
                         np.maximum(v, other))
            j >>= 1
        k <<= 1
    return v


def emulate_sort_emit(uniq, miss_buf, blocks=7, tile=512, max_tiles=32,
                      sort_threads=512):
    """The sort launch's plan chosen by the count, then the emit: the
    output keys and which path ran."""
    n = len(uniq)
    out = np.full(miss_buf, SENTINEL, np.int64)
    if n <= max_tiles * tile:
        length = tile if n >= tile else max(32, 1 << max(0, n - 1)
                                            .bit_length())
        runs = uniq.copy()
        for t in range(-(-n // tile)):
            v = np.full(tile, SENTINEL, np.int64)
            have = min(tile, n - t * tile)
            v[:have] = runs[t * tile:t * tile + have]
            runs[t * tile:t * tile + have] = emulate_sort_block(v,
                                                                length)[:have]
        tiles = -(-n // tile)
        for i in range(n):
            own = i // tile
            rank = i - own * tile
            for t in range(tiles):
                if t != own:
                    rank += _lower_bound(runs, runs[i], t * tile,
                                         min(tile, n - t * tile)) - t * tile
            if rank < miss_buf:
                out[rank] = runs[i]
        return out, "tiles"
    ordered = emulate_radix(uniq, blocks, sort_threads)
    k = min(n, miss_buf)
    out[:k] = ordered[:k]
    return out, "radix"


def _miss_case(case, rng, m=6000):
    if case == "many_unique":
        keys = rng.permutation(8 * m)[:m] - 3 * m  # negative keys too
        rows = np.full(m, -1)
        valid = np.ones(m, bool)
    elif case == "all_duplicate":
        keys = np.full(m, 41)
        rows = np.where(rng.random(m) < 0.7, -1, 2)
        valid = rng.random(m) < 0.9
    elif case == "sentinel_negative":
        keys = rng.integers(-40, 300, m)
        odd = rng.random(m)
        keys[odd < 0.1] = SENTINEL
        keys[(odd >= 0.1) & (odd < 0.15)] = -(2**31)
        rows = np.where(rng.random(m) < 0.6, -1, 9)
        valid = rng.random(m) < 0.9
    else:  # "cold_tick": every lane missing over few games
        keys = rng.integers(0, 500, m)
        rows = np.full(m, -1)
        valid = np.ones(m, bool)
    return keys.astype(np.int32), rows.astype(np.int32), valid


@pytest.mark.parametrize("case", ["many_unique", "all_duplicate",
                                  "sentinel_negative", "cold_tick"])
def test_miss_emulation_matches_plain_and_jax(case):
    """The mark (warp leaders, plain reads before claims, blocks in a
    random order), the sort chosen by the count and the emit, at two
    miss_buf sizes (one below the unique misses), equal the plain version
    and ``_miss_keys_kernel``; the emit leaves the table all sentinel."""
    rng = np.random.default_rng(len(case))
    keys, rows, valid = _miss_case(case, rng)
    p = max(1024, 1 << (2 * len(keys) - 1).bit_length())
    miss, uniq, slots, table, leaders = emulate_mark(
        keys.astype(np.int64), rows, valid, p, rng)
    assert leaders <= int(miss.sum())
    table[slots] = SENTINEL  # the emit's clean-up
    assert (table == SENTINEL).all()
    # tiles small enough that "many_unique" takes the radix path
    small = dict(tile=64, max_tiles=16, sort_threads=64)
    for miss_buf in (100, 1 << 13):
        got, path = emulate_sort_emit(uniq, miss_buf, **small)
        assert path == ("radix" if len(uniq) > 1024 else "tiles")
        want_keys, want_missing = kmiss.miss_keys_plain(
            torch.from_numpy(keys), torch.from_numpy(rows),
            torch.from_numpy(valid), miss_buf)
        np.testing.assert_array_equal(got, want_keys.numpy())
        np.testing.assert_array_equal(miss, want_missing.numpy())
        jax_keys, jax_missing = _miss_keys_kernel(
            jnp.asarray(keys), jnp.asarray(rows), jnp.asarray(valid),
            miss_buf=miss_buf)
        np.testing.assert_array_equal(got, np.asarray(jax_keys))
        np.testing.assert_array_equal(miss, np.asarray(jax_missing))


def test_miss_order_of_insertion_does_not_matter():
    """Blocks appending in different orders give different compact lists
    and the same output, on both sort paths."""
    rng = np.random.default_rng(11)
    keys, rows, valid = _miss_case("many_unique", rng, m=3000)
    outs = set()
    lists = set()
    for seed in range(3):
        _, uniq, _, _, _ = emulate_mark(keys.astype(np.int64), rows, valid,
                                        8192, np.random.default_rng(seed))
        lists.add(tuple(uniq[:50].tolist()))
        for max_tiles in (64, 4):
            got, _ = emulate_sort_emit(uniq, 4096, tile=64,
                                       max_tiles=max_tiles,
                                       sort_threads=64)
            outs.add(tuple(got.tolist()))
    assert len(lists) > 1 and len(outs) == 1


def test_miss_real_plan_on_the_main_paths_count():
    """At the kernel's own constants the cold tick's unique misses (10,000
    games) take the tile path with 20 tiles, the 1,000,000-unique case the
    radix path; cases through the real tile size (one short tile, several
    tiles) match the plain sort."""
    rng = np.random.default_rng(2)
    for n in (20, 4500):
        keys = rng.permutation(30_000)[:n].astype(np.int64) - 7000
        got, path = emulate_sort_emit(keys, 3000)
        assert path == "tiles"
        k = min(n, 3000)
        np.testing.assert_array_equal(got[:k], np.sort(keys)[:k])
    assert -(-10_000 // 512) == 20 and 10_000 <= 32 * 512 < 1_000_000


def test_miss_keys_wrapper_on_the_cpu():
    """The wrapper takes the plain version for CPU tensors (m = 0 too)."""
    empty = torch.zeros(0, dtype=torch.int32)
    out, missing = kmiss.miss_keys(empty, empty, torch.zeros(0, dtype=bool),
                                   8)
    assert (out == SENTINEL).all() and missing.numel() == 0
    assert kmiss.MAX_SORT_BLOCKS == 1024
