"""K10 ``resolve_wide`` and K8 ``attr_match`` on the CPU: what the CUDA
kernels compute is emulated in numpy, step by step as the kernels take it,
and held against the plain versions and the JAX functions
(``_resolve_rows_wide_kernel``, ``_apply_checked_stack``).

* K10's search (``csrc/resolve_tree.cuh``, plan ``resolve_plan``): a
  mirror of at most 4,095 hashes goes whole into the Eytzinger tree, and
  the descent's leaf is the lower bound; a longer one leaves there the
  last hash of every bucket of ``2**log_s`` hashes, the leaf is the bucket
  that holds the lower bound, lifted over sub-buckets of 8 by their last
  hashes, then one run of 8 hashes and rows; the first probe's hash and
  row come from the run, a collision or a missing row probing on in
  global memory, a probe whose hash differs ending the lane's probes.
* K10's lanes: 4 a thread after a scalar head up to ``lo``'s 16-byte
  boundary, a scalar tail, every group scalar where ``hi``, ``rows`` or
  ``valid`` do not share the offset; narrow mode (``hi`` absent) with the
  sentinel as padding.
* K8's match: a thread's 16 lanes of the plan against every entry, after
  a head up to the plan's 16-byte boundaries and with a scalar tail, an
  entry at another offset going lane by lane; chunks of 4,096 lanes over a
  persistent grid, each block publishing its entries' mismatch bits
  between chunks and skipping the entries known to differ; the last block
  by ticket writing flags and ``km`` and leaving its two state words zero.

The mirrors are made to order: every key is built from the hash it must
have (the hash's finalizer inverted), so runs of equal hashes sit astride
a run's or a bucket's edge, and colliding keys that are not in the mirror
probe through them.  Every value compared is an integer: the comparisons
are exact.  JAX is imported where the reference runs, so the card cases
(marked ``cuda``) also run on a machine without it.
"""

import numpy as np
import pytest
import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels import attr as kattr
from orleans_tpu_torch.kernels import resolve
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL
from orleans_tpu_torch.tensor.arena import mix32_np

INF = 2**31 - 1
M32 = 0xFFFFFFFF
RUN = 8        # K10: hashes of the 32-byte run
W_LANES = 4    # K10: lanes a thread
PROBES = 4     # the reference's WIDE_PROBES
M_THREADS, M_LANES = 256, 16   # K8's match: threads a block, lanes a thread


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- wide keys made from their hash --------------------------------------------

def _unshift(y, s):
    """The inverse of ``x ^= x >> s`` on 32 bits."""
    x = y
    for _ in range(32 // s):
        x = y ^ (x >> np.uint64(s))
    return x & np.uint64(M32)


def _keys_of_hash(h30, hi, top):
    """Words ``(hi, lo)`` whose ``mix32`` is ``h30``: the finalizer run
    backwards from ``h30 | top << 30``, then ``lo`` solved from ``hi``."""
    x = (np.asarray(h30, np.uint64) | (np.asarray(top, np.uint64) << 30))
    x = _unshift(x, 13)
    x = (x * np.uint64(pow(0x27D4EB2F, -1, 2**32))) & np.uint64(M32)
    x = _unshift(x, 15)
    hi_u = np.asarray(hi, np.int64).astype(np.uint64) & np.uint64(M32)
    lo = ((x ^ ((hi_u * np.uint64(0x85EBCA6B)) & np.uint64(M32)))
          * np.uint64(pow(0xC2B2AE35, -1, 2**32))) & np.uint64(M32)
    return (hi_u.astype(np.uint32).view(np.int32),
            lo.astype(np.uint32).view(np.int32))


def test_keys_of_hash_inverts_mix32():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2**30, 500)
    hi = rng.integers(-2**31, 2**31, 500)
    k_hi, k_lo = _keys_of_hash(h, hi, rng.integers(0, 4, 500))
    np.testing.assert_array_equal(mix32_np(k_hi, k_lo), h)
    z_hi, z_lo = _keys_of_hash(h, np.zeros(500, np.int64),
                               rng.integers(0, 4, 500))
    assert not z_hi.any()
    np.testing.assert_array_equal(mix32_np(z_hi, z_lo), h)


def _mirror(n, rng, narrow=False):
    """``device_index_wide`` of ``n`` slots, about 3/4 of them live: the
    sorted hashes (padded with ``INF``), each one's row (-1 for a few
    released keys and the padding), and the words of every row.  Runs of 2
    to 5 equal hashes sit astride run edges (8) and bucket edges; the
    true key of a 5-run is its last, out of the reference's probes.
    Returns the mirror and a pool of lookup keys: the live keys, keys that
    collide with them but are absent, and keys past every hash."""
    live = max(1, n - n // 4)
    h = np.sort(rng.choice(2**30 - 64, live, replace=False)).astype(np.int64)
    runs = [p for p in (7, 14, 30, 62, 127, 254, 4094, 8191)
            if p + 5 <= live]
    for q, p in enumerate(runs):
        h[p:p + 2 + q % 4] = h[p]
    h = np.sort(h)
    top = rng.integers(0, 4, live)
    hi = np.zeros(live, np.int64) if narrow else rng.integers(
        -2**31, 2**31, live)
    if narrow:  # the top bits tell up to four keys of a hash apart
        first = np.r_[True, h[1:] != h[:-1]]
        top = np.arange(live) - np.maximum.accumulate(
            np.where(first, np.arange(live), 0))
        top = top % 4
    k_hi, k_lo = _keys_of_hash(h, hi, top)
    cap = n
    rows = rng.permutation(cap)[:live].astype(np.int32)
    released = rng.random(live) < 0.05
    hi_col = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    lo_col = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    hi_col[rows], lo_col[rows] = k_hi, k_lo
    sorted_h = np.full(n, INF, np.int32)
    rows_by_h = np.full(n, -1, np.int32)
    sorted_h[:live] = h
    rows_by_h[:live] = np.where(released, -1, rows)
    # absent keys: the same hashes with other words, and hashes past all
    a_top = (top + 1) % 4 if narrow else top
    a_hi = hi if narrow else rng.integers(-2**31, 2**31, live)
    x_hi, x_lo = _keys_of_hash(h, a_hi, a_top)
    p_hi, p_lo = _keys_of_hash(np.full(8, 2**30 - 1), np.zeros(8, np.int64)
                               if narrow else rng.integers(0, 9, 8),
                               np.arange(8) % 4)
    pool_hi = np.concatenate([k_hi, x_hi, p_hi])
    pool_lo = np.concatenate([k_lo, x_lo, p_lo])
    return (sorted_h, rows_by_h, hi_col, lo_col), (pool_hi, pool_lo)


def _lanes(pool, m, rng, narrow=False):
    pick = rng.integers(0, len(pool[0]), m)
    hi, lo = pool[0][pick].copy(), pool[1][pick].copy()
    if narrow:
        lo[rng.random(m) < 0.05] = KEY_SENTINEL
        hi = None
    else:
        edge = rng.random(m) < 0.02
        hi[edge], lo[edge] = -1, -1
    valid = rng.random(m) < 0.9
    return hi, lo, valid


# -- K10: the emulation --------------------------------------------------------

def _tree(sk, levels, whole, log_s, last):
    """``ot_tree_fill``: in-order element j at its Eytzinger node."""
    n = len(sk)
    size = (1 << levels) - 1
    j = np.arange(size, dtype=np.int64)
    src = j if whole else ((j + 1) << log_s) - last
    t = np.array([(int(v + 1) & -int(v + 1)).bit_length() - 1 for v in j],
                 np.int64)
    node = (1 << (levels - 1 - t)) + ((j + 1) >> (t + 1))
    assert sorted(node.tolist()) == list(range(1, size + 1))
    tree = np.zeros(1 << levels, np.int64)
    tree[node] = np.where(src < n, sk[np.minimum(src, n - 1)], INF)
    return tree


def _probe_from(mirror, idx, k0, h, w_hi, w_lo):
    """The rare path, lane by lane: probes k0 .. 3 from idx in global
    memory, a differing hash ending them."""
    sorted_h, rows_by_h, hi_col, lo_col = mirror
    n, cap = len(sorted_h), len(hi_col)
    for k in range(k0, PROBES):
        j = min(idx + k, n - 1)
        if sorted_h[j] != h:
            return -1
        cand = rows_by_h[j]
        if cand < 0:
            continue
        cr = min(cand, cap - 1)
        if hi_col[cr] == w_hi and lo_col[cr] == w_lo:
            return int(cand)
    return -1


def emulate_resolve_lanes(mirror, w_hi, w_lo, v):
    """Every lane's row as K10's thread finds it: the descent, the lift,
    the run and the probes.  Returns the rows and the lower bounds."""
    sorted_h, rows_by_h, hi_col, lo_col = mirror
    n = len(sorted_h)
    sk = sorted_h.astype(np.int64)
    h = mix32_np(w_hi, w_lo).astype(np.int64)
    whole, levels, log_s, _ = resolve.resolve_plan(n)
    tree = _tree(sk, levels, whole, log_s, last=1)
    node = np.ones(len(h), np.int64)
    upper = np.full(len(h), INF, np.int64)
    for _ in range(levels):
        t = tree[node]
        lt = t < h
        upper = np.where(lt, upper, t)
        node = 2 * node + lt
    leaf = node - (1 << levels)
    if whole:
        idx, hv, slow = leaf, upper, np.zeros(len(h), bool)
        cand = np.where(v & (hv == h), rows_by_h[np.minimum(leaf, n - 1)],
                        -1)
    else:
        pos = leaf << log_s
        step = (1 << log_s) >> 1
        while step >= RUN:
            c = pos + step
            last = np.where(c - 1 < n, sk[np.minimum(c - 1, n - 1)], INF)
            pos = np.where(last < h, c, pos)
            step >>= 1
        assert not (pos % RUN).any()
        q = pos[:, None] + np.arange(RUN)
        rh = np.where(q < n, sk[np.minimum(q, n - 1)], INF)
        rr = np.where(q < n, rows_by_h[np.minimum(q, n - 1)], -1)
        c = (rh < h[:, None]).sum(1)
        slow = c == RUN
        assert not slow.any()  # the lift leaves the lower bound in the run
        idx = pos + c
        hv = rh[np.arange(len(h)), np.minimum(c, RUN - 1)]
        cand = rr[np.arange(len(h)), np.minimum(c, RUN - 1)]
    np.testing.assert_array_equal(idx, np.searchsorted(sk, h, "left"))
    cr = np.clip(cand, 0, len(hi_col) - 1)
    first = v & ~slow & (hv == h) & (cand >= 0) \
        & (hi_col[cr] == w_hi) & (lo_col[cr] == w_lo)
    rows = np.where(first, cand, -1).astype(np.int64)
    for i in np.flatnonzero(v & ~first & (slow | (hv == h))):
        rows[i] = _probe_from(mirror, int(idx[i]), 0 if slow[i] else 1,
                              h[i], w_hi[i], w_lo[i])
    return rows, idx


def lane_groups(m, at_lo, at_hi, at_rows, at_valid, narrow):
    """K10's groups (base, end, full) from the views' offsets in bytes
    from a 16-byte boundary."""
    head = min((16 - at_lo) % 16 // 4, m)
    vec = head < m and at_lo % 4 == 0 and (narrow or at_hi == at_lo) \
        and at_rows == at_lo and (at_valid + head) % 4 == 0
    if not vec:
        head = 0
    groups = [(0, head, False)] if head else []
    for base in range(head, m, W_LANES):
        end = min(base + W_LANES, m)
        groups.append((base, end, vec and end - base == W_LANES))
    return groups


def emulate_resolve_wide(mirror, hi, lo, valid, offsets=(0, 0, 0, 0)):
    """K10 as a launch takes it: (rows, misses)."""
    m = len(lo)
    narrow = hi is None
    w_hi = np.zeros(m, np.int32) if narrow else hi
    v = valid & (lo < KEY_SENTINEL) if narrow else valid.copy()
    lane_rows, _ = emulate_resolve_lanes(mirror, w_hi, lo, v)
    rows = np.full(m, -7, np.int64)
    for base, end, full in lane_groups(m, *offsets, narrow):
        if full:
            assert (4 * base + offsets[0]) % 16 == 0
            assert (base + offsets[3]) % 4 == 0
        assert (rows[base:end] == -7).all()
        rows[base:end] = lane_rows[base:end]
    assert (rows != -7).all()
    return rows, int((v & (rows < 0)).sum())


def _reference(mirror, hi, lo, valid):
    """JAX ``_resolve_rows_wide_kernel``, narrow mode as the engine takes
    it (engine.py's ``resolve_rows_on_device``)."""
    import jax.numpy as jnp

    from orleans_tpu.tensor.engine import _resolve_rows_wide_kernel

    if hi is None:
        valid = valid & (lo < KEY_SENTINEL)
        hi = np.zeros_like(lo)
    rows, misses = _resolve_rows_wide_kernel(
        *(jnp.asarray(a) for a in mirror), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(valid))
    return np.asarray(rows, np.int64), int(misses)


@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 16384])
@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_resolve_wide_emulation_matches_plain_and_jax(n, narrow):
    """Mirrors of 1 and 7 keys and at the tree's edge (4,095 whole, 4,096
    in buckets of 8) and past it (16,384, buckets of 8 with 2,048 in the
    tree), with runs of equal hashes across the run and bucket edges."""
    rng = np.random.default_rng(n + narrow)
    mirror, pool = _mirror(n, rng, narrow)
    hi, lo, valid = _lanes(pool, 2003, rng, narrow)
    got = emulate_resolve_wide(mirror, hi, lo, valid)
    plain = resolve.resolve_wide_plain(
        *(_t(a) for a in mirror), None if narrow else _t(hi), _t(lo),
        _t(valid))
    want = _reference(mirror, hi, lo, valid)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(plain[0].numpy(), want[0])
    assert got[1] == int(plain[1]) == want[1]
    hits = (want[0] >= 0).sum()
    assert 0 < hits < valid.sum()  # both hits and misses


def test_resolve_wide_emulation_lifts_through_buckets():
    """A mirror of 2**17 slots: buckets of 32 hashes, lifted twice (16,
    8) in L2 before the run; colliding keys probing on from the run."""
    rng = np.random.default_rng(3)
    mirror, pool = _mirror(1 << 17, rng)
    assert resolve.resolve_plan(1 << 17)[2] == 5
    hi, lo, valid = _lanes(pool, 1001, rng)
    got = emulate_resolve_wide(mirror, hi, lo, valid)
    want = resolve.resolve_wide_plain(*(_t(a) for a in mirror), _t(hi),
                                      _t(lo), _t(valid))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert got[1] == int(want[1])


@pytest.mark.parametrize("offsets,m,full_groups", [
    ((0, 0, 0, 0), 1001, 250),    # tail of 1
    ((4, 4, 4, 1), 1001, 249),    # head of 3 (valid agrees), tail of 2
    ((8, 8, 0, 2), 1001, 0),      # rows at another offset: all scalar
    ((12, 12, 12, 0), 2, 0),      # fewer lanes than the head
    ((0, 4, 0, 0), 9, 0),         # hi at another offset
])
def test_resolve_wide_lane_groups(offsets, m, full_groups):
    """The head up to ``lo``'s boundary, the 4-lane groups and the tail
    cover every lane once; the groups are 16-byte only where every view
    shares ``lo``'s offset."""
    groups = lane_groups(m, *offsets, False)
    covered = np.zeros(m, int)
    for base, end, _ in groups:
        covered[base:end] += 1
    assert (covered == 1).all()
    assert sum(full for _, _, full in groups) == full_groups
    rng = np.random.default_rng(m)
    mirror, pool = _mirror(64, rng)
    hi, lo, valid = _lanes(pool, m, rng)
    got = emulate_resolve_wide(mirror, hi, lo, valid, offsets)
    want = _reference(mirror, hi, lo, valid)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_resolve_wide_takes_interleaved_key_words():
    """The arena keeps the two word columns interleaved (views of stride
    2 of one ``[capacity, 2]`` array); the wrapper takes them as it takes
    two columns, and refuses a strided column that is not such a pair."""
    from orleans_tpu_torch.samples import presence_wide  # noqa: F401
    from orleans_tpu_torch.tensor.arena import GrainArena, split_wide_keys
    from orleans_tpu_torch.tensor.vector_grain import vector_type

    rng = np.random.default_rng(8)
    keys = np.unique(rng.integers(0, 2**63 - 1, 700, np.int64))
    arena = GrainArena(vector_type("WideGame"), torch.device("cpu"))
    arena.resolve_rows(keys)
    sorted_h, rows_by_h, hi_col, lo_col = arena.device_index_wide()
    assert hi_col.stride(0) == lo_col.stride(0) == 2
    assert lo_col.data_ptr() == hi_col.data_ptr() + 4
    pick = rng.choice(keys, 999)
    hi, lo = (_t(w) for w in split_wide_keys(pick))
    valid = torch.ones(999, dtype=torch.bool)
    got = resolve.resolve_wide(sorted_h, rows_by_h, hi_col, lo_col, hi, lo,
                               valid)
    want = resolve.resolve_wide(sorted_h, rows_by_h, hi_col.contiguous(),
                                lo_col.contiguous(), hi, lo, valid)
    assert torch.equal(got[0], want[0]) and int(want[1]) == 0
    np.testing.assert_array_equal(got[0].numpy(),
                                  arena.lookup_rows(pick)[0])
    with pytest.raises(ValueError):
        resolve.resolve_wide(sorted_h, rows_by_h, hi_col, lo_col.contiguous(),
                             hi, lo, valid)


# -- K8's match: the emulation -------------------------------------------------

def _load16(rows, valid, base, end):
    """16 lanes (0 past ``end``): rows and the valid flags' nonzero-ness."""
    r = np.zeros(M_LANES, np.int64)
    v = np.zeros(M_LANES, bool)
    r[:end - base] = rows[base:end]
    v[:end - base] = np.asarray(valid[base:end]) != 0
    return r, v


def emulate_attr_match(rows_list, valid_list, plan_rows, plan_valid,
                       offsets, blocks_cap):
    """K8's match launch: ``offsets`` gives each array's byte offset from
    a 16-byte boundary, ``(plan_rows, plan_valid, [(rows, valid), ...])``;
    ``blocks_cap`` the blocks the card holds at once.  The blocks run
    their chunks in rounds, each publishing its mismatch bits between
    chunks.  Returns (flags, km, the state words after, the loads of
    entry groups skipped)."""
    k, m = len(rows_list), len(plan_rows)
    at_r, at_v, entry_at = offsets
    head = (16 - at_v) % 16
    vec_plan = at_r % 4 == 0 and (at_r + 4 * head) % 16 == 0 and head < m
    if not vec_plan:
        head = 0
    vec = [vec_plan and entry_at[e] == (at_r, at_v) for e in range(k)]
    has_head = head > 0
    units = has_head + -(-(m - head) // M_LANES)
    chunks = -(-units // M_THREADS)
    grid = max(1, min(chunks, blocks_cap))
    every = (1 << k) - 1
    state = [0, 0]             # the pool: mismatch mask, ticket
    s_mask = [0] * grid        # each block's shared mask
    known = [0] * grid
    skipped = 0
    left_early = False
    seen = np.zeros(m, int)
    for r in range(-(-chunks // grid)):
        published = []
        for b in range(grid):
            c = b + r * grid
            if c >= chunks:
                continue
            if known[b] == every:  # the block leaves: nothing left to learn
                left_early = True
                skipped += k * (min((c + 1) * M_THREADS, units)
                                - c * M_THREADS)
                continue
            d = 0
            for u in range(c * M_THREADS, min((c + 1) * M_THREADS, units)):
                is_head = has_head and u == 0
                base = 0 if is_head else head + M_LANES * (u - has_head)
                end = head if is_head else min(base + M_LANES, m)
                full = vec_plan and not is_head and end - base == M_LANES
                if full:
                    assert (at_r + 4 * base) % 16 == 0
                    assert (at_v + base) % 16 == 0
                seen[base:end] += 1
                plan = _load16(plan_rows, plan_valid, base, end)
                for e in range(k):
                    if (known[b] >> e) & 1:
                        skipped += 1
                        continue
                    x = _load16(rows_list[e], valid_list[e], base, end)
                    if (x[0] != plan[0]).any() or (x[1] != plan[1]).any():
                        d |= 1 << e
            s_mask[b] |= d
            published.append(b)
        # between chunks: push the new bits, read the pool's mask back
        for b in published:
            state[0] |= s_mask[b]
        for b in published:
            known[b] = (state[0] | s_mask[b]) & every
    assert (seen <= 1).all() and (left_early or (seen == 1).all())
    # the ticket: the last block writes the answer and clears the state
    for b in range(grid):
        ticket = state[1]
        state[1] += 1
        if ticket == grid - 1:
            mask = state[0] & every
            state = [0, 0]
            flags = [(mask >> e) & 1 for e in range(k)]
            km = k - bin(mask).count("1")
    return flags, km, state, skipped


def _match_case(case, rng, m):
    """(rows_list, valid_list, plan_rows, plan_valid, offsets)."""
    plan_rows = rng.integers(0, 40_000, m).astype(np.int32)
    plan_valid = rng.random(m) < 0.8
    k = {"k1": 1, "k16_lane0": 16, "k16_last": 16, "k16_valid_only": 16,
         "k16_all_stale": 16, "k32_odd_offset": 32, "k32_match": 32,
         "k16_plan_odd": 16}[case]
    rows = [plan_rows.copy() for _ in range(k)]
    valid = [plan_valid.copy() for _ in range(k)]
    entry_at = [(0, 0)] * k
    at = (0, 0)
    if case == "k1":
        rows[0][m // 2] += 1
    elif case == "k16_lane0":
        rows[5][0] -= 1
        rows[15][0] += 3
    elif case == "k16_last":
        rows[0][m - 1] ^= 1
        valid[9][m - 1] = ~valid[9][m - 1]
    elif case == "k16_valid_only":
        valid[7][m // 3] = ~valid[7][m // 3]
    elif case == "k16_all_stale":
        for e in range(k):
            rows[e][(e * 997) % m] += 1
    elif case == "k32_odd_offset":
        # each entry one word and one byte past a boundary, as slices of a
        # longer buffer are; one differs in its last lane
        entry_at = [((4 * (e + 1)) % 16, (e + 1) % 16) for e in range(k)]
        rows[20][m - 1] += 1
    elif case == "k16_plan_odd":
        # the plan itself at an odd offset; half the entries share it
        at = (4, 13)
        entry_at = [(4, 13) if e % 2 else (0, 0) for e in range(k)]
        rows[4][17] += 1
        valid[11][m - 2] = ~valid[11][m - 2]
    return rows, valid, plan_rows, plan_valid, (at[0], at[1], entry_at)


MATCH_CASES = ["k1", "k16_lane0", "k16_last", "k16_valid_only",
               "k16_all_stale", "k32_odd_offset", "k32_match",
               "k16_plan_odd"]


@pytest.mark.parametrize("case", MATCH_CASES)
def test_attr_match_emulation_matches_plain(case):
    """Every case at m = 10,001 (not a multiple of 16; three chunks of
    4,096 lanes) over a grid of 2 blocks, so a block takes two chunks
    and skips what it knows; the state words end zero."""
    rng = np.random.default_rng(MATCH_CASES.index(case))
    m = 10_001
    rows, valid, plan_rows, plan_valid, offsets = _match_case(case, rng, m)
    flags, km, state, skipped = emulate_attr_match(
        rows, valid, plan_rows, plan_valid, offsets, blocks_cap=2)
    k = len(rows)
    p_flags = torch.full((k,), 7, dtype=torch.int32)
    p_km = torch.zeros(1, dtype=torch.int32)
    kattr.attr_match_plain([_t(r) for r in rows], [_t(v) for v in valid],
                           _t(plan_rows), _t(plan_valid), p_flags, p_km)
    assert flags == p_flags.tolist() and km == int(p_km[0])
    assert state == [0, 0]
    if case in ("k1", "k16_all_stale"):
        assert km == 0 and skipped > 0


@pytest.mark.parametrize("case", ["k1", "k16_last", "k16_all_stale"])
def test_attr_match_emulation_km_matches_jax(case):
    """km against JAX ``_apply_checked_stack``: its stale count is the
    number of mismatched entries, k - km."""
    import jax.numpy as jnp

    from orleans_tpu.tensor import attribution as jattr

    rng = np.random.default_rng(40 + MATCH_CASES.index(case))
    m, cap = 999, 40_000
    rows, valid, plan_rows, plan_valid, offsets = _match_case(case, rng, m)
    _, km, _, _ = emulate_attr_match(rows, valid, plan_rows, plan_valid,
                                     offsets, blocks_cap=1)
    k = len(rows)
    pad = jattr.pow2ceil(k)
    seeds = jnp.asarray(np.arange(1, 5, dtype=np.uint32) * 0x9E3779B1)
    plan = jattr._plan_kernel(jnp.asarray(plan_rows),
                              jnp.asarray(plan_valid), seeds, cap=cap,
                              width=64, depth=4)
    out = jattr._apply_checked_stack(
        jnp.zeros(cap, jnp.int32), jnp.zeros((4, 64), jnp.int32),
        jnp.zeros(8, jnp.int32), jnp.zeros((), jnp.int32),
        jnp.asarray(plan_rows), jnp.asarray(plan_valid), plan[0], plan[1],
        plan[2], seeds, jnp.int32(0),
        jnp.asarray(np.stack(rows + [plan_rows] * (pad - k))),
        jnp.asarray(np.stack(valid + [plan_valid] * (pad - k))),
        jnp.asarray(np.arange(pad) < k))
    assert km == k - int(out[3])


def test_attr_match_emulation_empty_lanes():
    """m = 0: one block, no chunk, every entry matches."""
    e = np.zeros(0, np.int32)
    flags, km, state, _ = emulate_attr_match(
        [e] * 3, [e.astype(bool)] * 3, e, e.astype(bool),
        (0, 0, [(0, 0)] * 3), blocks_cap=4)
    assert flags == [0, 0, 0] and km == 3 and state == [0, 0]


# -- the kernels on the card ---------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 16384, 1 << 17])
@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_resolve_wide_kernel_matches_plain(cuda_device, n, narrow):
    """K10 against its plain version at every mirror plan, its key words
    as two columns and interleaved, with views of the lanes one word past
    a boundary (scalar groups) beside aligned ones, into a given
    counter."""
    rng = np.random.default_rng(100 + n + narrow)
    mirror, pool = _mirror(n, rng, narrow)
    hi, lo, valid = _lanes(pool, 300_001, rng, narrow)
    cpu = [_t(a) for a in mirror]
    dev = [a.to(cuda_device) for a in cpu]
    want = resolve.resolve_wide_plain(*cpu, None if narrow else _t(hi),
                                      _t(lo), _t(valid))
    words = torch.stack([dev[2], dev[3]], dim=1)  # the arena's layout
    pair = (*dev[:2], words[:, 0], words[:, 1])
    for off, mirror in ((0, dev), (1, dev), (0, pair), (1, pair)):
        def view(a):
            if a is None:
                return None
            pad = np.concatenate([a[:off], a]) if off else a
            return _t(pad).to(cuda_device)[off:]
        counter = torch.full((1,), 5, dtype=torch.int32, device=cuda_device)
        rows, _ = resolve.resolve_wide(*mirror, view(hi), view(lo),
                                       view(valid), counter)
        assert torch.equal(rows.cpu(), want[0])
        assert int(counter[0]) == 5 + int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATCH_CASES)
def test_attr_match_kernel_matches_plain(cuda_device, case):
    """K8's match against its plain version, the views at the case's
    offsets, twice in a row (the state words left clean) and once with
    m = 0."""
    rng = np.random.default_rng(200 + MATCH_CASES.index(case))
    m = 1_000_003
    rows, valid, plan_rows, plan_valid, offsets = _match_case(case, rng, m)

    def placed(a, byte_off):
        item = a.itemsize
        pad = byte_off // item
        buf = torch.zeros(a.shape[0] + 16, dtype=_t(a).dtype,
                          device=cuda_device)
        buf[pad:pad + a.shape[0]] = _t(a).to(cuda_device)
        return buf[pad:pad + a.shape[0]]

    at_r, at_v, entry_at = offsets
    d_rows = [placed(r, o[0]) for r, o in zip(rows, entry_at)]
    d_valid = [placed(v, o[1]) for v, o in zip(valid, entry_at)]
    d_plan = (placed(plan_rows, at_r), placed(plan_valid, at_v))
    k = len(rows)
    want = [torch.full((k,), 7, dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)]
    kattr.attr_match_plain([_t(r) for r in rows], [_t(v) for v in valid],
                           _t(plan_rows), _t(plan_valid), *want)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for _ in range(2):
        got = [torch.full((k,), 7, dtype=torch.int32, device=cuda_device),
               torch.zeros(1, dtype=torch.int32, device=cuda_device)]
        kattr.attr_match(d_rows, d_valid, *d_plan, *got)
        assert got[0].cpu().tolist() == want[0].tolist()
        assert int(got[1][0]) == int(want[1][0])
        state = _build._STREAM_POOLS[("attr_match", d_plan[0].device,
                                      stream)][1]
        assert state.tolist() == [0, 0]
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    none = torch.zeros(0, dtype=torch.bool, device=cuda_device)
    got = [torch.full((3,), 7, dtype=torch.int32, device=cuda_device),
           torch.zeros(1, dtype=torch.int32, device=cuda_device)]
    kattr.attr_match([empty] * 3, [none] * 3, empty, none, *got)
    assert got[0].cpu().tolist() == [0, 0, 0] and int(got[1][0]) == 3
