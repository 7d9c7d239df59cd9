"""The workload-attribution kernels and their plain PyTorch versions.

* K7 ``attr_fold`` (``csrc/attr_fold.cu``): one fold of lanes (or of a
  dense per-row weight) into the per-row counts, the count-min sketch and
  one int32 total, optionally gated on a device flag.  Replaces
  ``fold_batch``, ``fold_counts``, ``fold_cms_dense`` and
  ``_plan_kernel`` of ``orleans_tpu/tensor/attribution.py``.
* K8 ``attr_apply`` / ``attr_match`` (``csrc/attr_apply.cu``): the flush
  of buffered folds against one delta plan — a k-fold multiply-add with
  k on the host or on the device (``_apply_coalesced``), and the exact
  compare of up to 32 entries against the plan that
  ``_apply_checked_stack`` starts with.
* K9 ``attr_snapshot`` (``csrc/attr_snapshot.cu``): the device half of a
  snapshot (``_snapshot_kernel``): total, top-k (ties lower row first),
  per-shard sums, nonzero rows, p99, Gini, mean and the sketch estimate
  of the top rows, packed into one int64 vector (``decode_snapshot``).
  Bound by bytes: p99 and Gini need the counts' ascending order, which
  no sort reaches in the one read of the counts that bounds it.  The
  kernel sorts the 4-byte counts alone with a one-sweep LSD radix sort
  that skips the digits all counts share, reads Gini and p99 from the
  sorted values, and finds the top-k rows by a compaction of the rows
  at or above the k-th largest count, so only k rows are ever ordered.

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors.  ``cms_hash`` is the sketch hash the kernels
compute inline, in int64 arithmetic masked to 32 bits (the JAX package
computes it in uint32).  What bounds each kernel on an H100 and what its
design does about it is in the note at the top of its source.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIG_FOLD = {"attr_fold": (_P, _I64, _P, _INT, _I64, _P, _P, _P, _P, _P,
                           _I64, _P, _P, _INT, _INT, _INT, _I64, _INT, _P),
             "attr_fold_init": ()}
_SIG_APPLY = {"attr_apply": (_P, _P, _I64, _I64, _INT, _P, _P, _I64, _I64,
                             _INT, _P, _P, ctypes.c_int32, _P, _INT, _INT,
                             _P),
              "attr_match": (_P, _P, _INT, _P, _P, _I64, _P, _P, _P, _P)}
_SIG_SNAPSHOT = {"attr_snapshot": (_P, _I64, _P, _INT, _I64, _P, _INT, _INT,
                                   _P, _P, _P),
                 "attr_snapshot_scratch": (_I64, _INT, _INT, _P)}

#: entries one ``attr_match`` launch compares (the flush buffer's cap)
MAX_STACK = 32
_MAX_DEPTH = 8
_M32 = 0xFFFFFFFF


# -- the sketch hash ----------------------------------------------------------

def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``u * c mod 2**32`` for int64 ``u`` in ``[0, 2**32)``, without an
    int64 overflow: the constant splits into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _M32


def cms_hash(rows: torch.Tensor, seeds: Sequence[int],
             width: int) -> torch.Tensor:
    """``[len(seeds), m]`` int32 sketch buckets of int32 ``rows``:
    ``orleans_tpu/tensor/attribution.py`` ``cms_hash`` in int64 masked to
    32 bits (a negative row enters as its two's-complement bits)."""
    u0 = rows.to(torch.int64) & _M32
    out = []
    for seed in seeds:
        u = _mul32(u0, int(seed))
        u = u ^ (u >> 15)
        u = _mul32(u, 0x27D4EB2F)
        u = u ^ (u >> 13)
        out.append(u & (width - 1))
    return torch.stack(out).to(torch.int32)


# -- argument checks ----------------------------------------------------------

def _vec(name: str, t: Optional[torch.Tensor], dtype: torch.dtype,
         device: torch.device, dim: int = 1) -> None:
    if t is None:
        return
    if not isinstance(t, torch.Tensor) or t.dtype != dtype \
            or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous {dim}-D {dtype} "
                        f"tensor")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _device_of(*ts: Optional[torch.Tensor]) -> torch.device:
    for t in ts:
        if isinstance(t, torch.Tensor):
            if t.device.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {t.device}")
            return t.device
    raise ValueError("no tensor given")


def _check_sketch(cms: Optional[torch.Tensor], seeds: Sequence[int],
                  device: torch.device) -> None:
    if cms is None:
        return
    _vec("cms", cms, torch.int32, device, dim=2)
    depth, width = cms.shape
    if not 1 <= depth <= min(_MAX_DEPTH, len(seeds)):
        raise ValueError(f"sketch depth {depth} needs 1..{_MAX_DEPTH} "
                         f"seeds, got {len(seeds)}")
    if width < 1 or width & (width - 1):
        raise ValueError(f"sketch width {width} is not a power of two")


def _check_total(total: Optional[torch.Tensor], slot: int,
                 device: torch.device) -> None:
    if total is None:
        return
    _vec("total", total, torch.int32, device)
    if not 0 <= slot < total.shape[0]:
        raise IndexError(f"slot {slot} outside total of {total.shape[0]}")


def _seed_array(seeds: Sequence[int]):
    arr = (ctypes.c_uint32 * _MAX_DEPTH)()
    for d, s in enumerate(list(seeds)[:_MAX_DEPTH]):
        arr[d] = int(s) & _M32
    return arr


def _ptr(t: Optional[torch.Tensor], offset: int = 0) -> Optional[int]:
    return None if t is None else t.data_ptr() + 4 * offset


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- K7 attr_fold -------------------------------------------------------------

#: blocks of a thread-block cluster that sum their histograms together
#: (8 is the portable size)
FOLD_CLUSTER = 8
#: histogram bytes each block of a cluster holds at most (a full copy;
#: the kernel lets a block take up to 200 KB)
FOLD_BLOCK_BYTES = 128 * 1024
#: lanes (times depths) per histogram word from which a target is
#: privatized in the blocks' shared memory
FOLD_MIN_PER_WORD = 8
#: persistent grids: blocks on each SM, of 256 threads (direct) and of
#: 1,024 (cluster)
FOLD_BLOCKS_PER_SM = 4
FOLD_CLUSTER_BLOCKS_PER_SM = 1


class FoldPlan(NamedTuple):
    """K7's path for one call's shapes: every block of a cluster of
    ``cluster`` blocks (0: direct atomics only) folds its lanes into its
    own histogram of the counts and/or the sketch, then block ``r`` sums
    the cluster's words ``[r * chunk, (r + 1) * chunk)``."""
    cluster: int
    hist_counts: bool
    hist_cms: bool
    chunk: int

    def block_words(self, cap: int, depth: int, width: int
                    ) -> List[Tuple[int, int]]:
        """The histogram words ``[lo, hi)`` each block of a cluster sums
        and adds into global memory: the counts' rows first when held,
        then the sketch's ``d * width + bucket``."""
        words = cap * self.hist_counts + depth * width * self.hist_cms
        return [(min(r * self.chunk, words), min((r + 1) * self.chunk, words))
                for r in range(self.cluster)]


def fold_plan(m: int, cap: int, depth: int, width: int,
              weighted: bool) -> FoldPlan:
    """K7's path from shapes alone (a CUDA graph bakes the launch, so it
    never looks at data): ``m`` lanes (weighted: rows), ``cap`` counts
    rows, a ``depth`` x ``width`` sketch (depth 0: none).  A target goes
    into the blocks' histograms when at least ``FOLD_MIN_PER_WORD``
    lanes per word may hit it — never the weighted counts, which each
    row owns — and the histogram fits a block; the sketch is preferred
    when both do not fit."""
    hist_counts = not weighted and cap > 0 and m >= FOLD_MIN_PER_WORD * cap
    hist_cms = depth > 0 and m >= FOLD_MIN_PER_WORD * width
    budget = FOLD_BLOCK_BYTES // 4
    if hist_cms and depth * width > budget:
        hist_cms = False
    if hist_counts and cap + depth * width * hist_cms > budget:
        hist_counts = False
    if not (hist_counts or hist_cms):
        return FoldPlan(0, False, False, 0)
    words = cap * hist_counts + depth * width * hist_cms
    chunk = -(-words // FOLD_CLUSTER)
    return FoldPlan(FOLD_CLUSTER, hist_counts, hist_cms, -(-chunk // 4) * 4)


def _check_fold(counts, cms, seeds, rows, valid, total, slot, weight, gate,
                stale) -> torch.device:
    dev = _device_of(counts, cms, weight, rows)
    _vec("counts", counts, torch.int32, dev)
    _check_sketch(cms, seeds, dev)
    _check_total(total, slot, dev)
    _vec("gate", gate, torch.int32, dev)
    _vec("stale", stale, torch.int32, dev)
    if gate is not None and gate.shape[0] != 1:
        raise ValueError("gate must hold one element")
    if weight is not None:
        if rows is not None or valid is not None:
            raise ValueError("weighted mode takes no rows or valid")
        _vec("weight", weight, torch.int32, dev)
        if counts is not None and counts.shape != weight.shape:
            raise ValueError("counts and weight must share their length")
    else:
        if counts is None:
            raise ValueError("lane mode needs counts (its length bounds "
                             "the rows)")
        _vec("rows", rows, torch.int32, dev)
        _vec("valid", valid, torch.bool, dev)
        if rows is None or valid is None or rows.shape != valid.shape:
            raise ValueError("lane mode needs rows and valid of one shape")
    return dev


def attr_fold_plain(counts: Optional[torch.Tensor],
                    cms: Optional[torch.Tensor], seeds: Sequence[int],
                    rows: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None, *,
                    total: Optional[torch.Tensor] = None, slot: int = 0,
                    weight: Optional[torch.Tensor] = None,
                    gate: Optional[torch.Tensor] = None,
                    stale: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of ``attr_fold`` (same in-place contract)."""
    if gate is not None and int(gate[0]) == 0:
        return
    if weight is not None:
        inc = weight
        r = torch.arange(weight.shape[0], dtype=torch.int32,
                         device=weight.device)
    else:
        ok = valid & (rows >= 0) & (rows < counts.shape[0])
        inc = ok.to(torch.int32)
        r = torch.where(ok, rows, torch.zeros_like(rows))
    if inc.shape[0]:
        if counts is not None:
            counts.index_add_(0, r.long(), inc)
        if cms is not None:
            h = cms_hash(r, list(seeds)[:cms.shape[0]], cms.shape[1]).long()
            for d in range(cms.shape[0]):
                cms[d].index_add_(0, h[d], inc)
    if total is not None:
        total[slot] += inc.sum(dtype=torch.int32)
    if gate is not None and stale is not None:
        stale += 1


@_build.counted
def attr_fold(counts: Optional[torch.Tensor], cms: Optional[torch.Tensor],
              seeds: Sequence[int], rows: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None, *,
              total: Optional[torch.Tensor] = None, slot: int = 0,
              weight: Optional[torch.Tensor] = None,
              gate: Optional[torch.Tensor] = None,
              stale: Optional[torch.Tensor] = None) -> None:
    """Fold in place.  Lane mode (``rows``, ``valid``): every valid lane
    with ``0 <= row < len(counts)`` adds 1 into ``counts[row]`` and into
    its bucket at each depth of ``cms``.  Weighted mode (``weight``, one
    int32 per row): row ``i`` adds ``weight[i]``.  The sum of the
    increments adds into ``total[slot]``.  ``counts``, ``cms`` and
    ``total`` may each be None (weighted mode needs no counts).  With a
    one-element ``gate``, nothing happens while ``gate[0] == 0``;
    otherwise ``stale`` also gains 1."""
    dev = _check_fold(counts, cms, seeds, rows, valid, total, slot, weight,
                      gate, stale)
    if dev.type == "cpu":
        return attr_fold_plain(counts, cms, seeds, rows, valid, total=total,
                               slot=slot, weight=weight, gate=gate,
                               stale=stale)
    m = (weight if weight is not None else rows).shape[0]
    depth, width = cms.shape if cms is not None else (0, 1)
    cap = counts.shape[0] if counts is not None else m
    plan = fold_plan(m, cap, depth, width, weight is not None)
    seeds_arr = _seed_array(seeds)
    lib = _build.library("attr_fold", _SIG_FOLD, init="attr_fold_init")
    err = lib.attr_fold(
        _ptr(counts), cap, _ptr(cms), depth, width,
        ctypes.addressof(seeds_arr), _ptr(total, slot), _ptr(rows),
        _ptr(valid), _ptr(weight), m, _ptr(gate), _ptr(stale),
        plan.cluster, int(plan.hist_counts), int(plan.hist_cms), plan.chunk,
        FOLD_CLUSTER_BLOCKS_PER_SM if plan.cluster else FOLD_BLOCKS_PER_SM,
        _stream(dev))
    _build.check(lib, err, "attr_fold")
    _build.note_launch(attr_fold)


# -- K8 attr_apply / attr_match -----------------------------------------------

#: threads of an ``attr_apply`` block (halved, down to
#: ``APPLY_MIN_THREADS``, while the grid would cover fewer threads than the
#: SMs hold, so a small flush spreads over the SMs), and the persistent
#: grid's blocks on each SM
APPLY_THREADS = 256
APPLY_MIN_THREADS = 64
APPLY_BLOCKS_PER_SM = 4
#: a flush of at most this many words reads each accumulator group with
#: its delta, not after it: one round trip to device memory instead of
#: two, at the price of reading the groups its delta leaves untouched
APPLY_EAGER_WORDS = 1 << 17


class ApplySplit(NamedTuple):
    """How K8 walks one array of ``n`` words: ``head`` words one by one,
    then ``groups`` 16-byte groups of 4 words, then ``tail`` words one by
    one.  An accumulator and a delta that differ in their address modulo
    16 bytes go word by word (``head == n``)."""
    head: int
    groups: int
    tail: int


def apply_split(n: int, acc_ptr: int, delta_ptr: int) -> ApplySplit:
    """K8's split of one array from its length and its two addresses (a
    CUDA graph bakes them, so nothing here depends on data)."""
    if (acc_ptr - delta_ptr) % 16:
        return ApplySplit(n, 0, 0)
    head = min((-delta_ptr % 16) // 4, n)
    groups = (n - head) // 4
    return ApplySplit(head, groups, n - head - 4 * groups)


class ApplyPlan(NamedTuple):
    """K8's launch: ``blocks_c`` blocks on the counts, then ``blocks_s``
    on the sketch, of ``threads`` threads; ``eager``: read the
    accumulator groups together with their deltas."""
    blocks_c: int
    blocks_s: int
    threads: int
    eager: bool


def apply_plan(counts: ApplySplit, cms: ApplySplit, sms: int) -> ApplyPlan:
    """K8's launch from the two splits: one 16-byte group (or word, for
    the word-by-word part) per thread where the grid allows, else the
    ``sms * APPLY_BLOCKS_PER_SM`` blocks of the persistent grid shared in
    proportion to each range's groups, at least one block to a range that
    has any word."""

    def units(s: ApplySplit) -> int:
        return max(s.groups, s.head + s.tail)

    threads = APPLY_THREADS
    while threads > APPLY_MIN_THREADS \
            and units(counts) + units(cms) < sms * threads:
        threads //= 2
    wc, ws = (-(-units(s) // threads) for s in (counts, cms))
    cap = max(2, sms * APPLY_BLOCKS_PER_SM)
    if wc + ws > cap:
        bc = min(wc, max(1 if wc else 0, cap * wc // (wc + ws)))
        wc, ws = bc, min(ws, max(1 if ws else 0, cap - bc))
    words = sum(s.head + 4 * s.groups + s.tail for s in (counts, cms))
    return ApplyPlan(wc, ws, threads, words <= APPLY_EAGER_WORDS)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_apply(counts, cdelta, cms, sdelta, k, total, slot, n
                 ) -> torch.device:
    dev = _device_of(counts)
    _vec("counts", counts, torch.int32, dev)
    _vec("cdelta", cdelta, torch.int32, dev)
    _vec("cms", cms, torch.int32, dev, dim=2)
    _vec("sdelta", sdelta, torch.int32, dev, dim=2)
    if counts.shape != cdelta.shape or cms.shape != sdelta.shape:
        raise ValueError("accumulators and deltas must share their shapes")
    _check_total(total, slot, dev)
    if total is not None:
        _vec("n", n, torch.int32, dev)
        if n is None or n.shape[0] != 1:
            raise ValueError("a total needs the plan's one-element lane "
                             "total n")
    if isinstance(k, torch.Tensor):
        _vec("k", k, torch.int32, dev)
        if k.shape[0] != 1:
            raise ValueError("a device k holds one element")
    elif not isinstance(k, (int, np.integer)):
        raise TypeError(f"k must be an int or a device scalar, got {type(k)}")
    return dev


def attr_apply_plain(counts: torch.Tensor, cdelta: torch.Tensor,
                     cms: torch.Tensor, sdelta: torch.Tensor,
                     k: Union[int, torch.Tensor], *,
                     total: Optional[torch.Tensor] = None, slot: int = 0,
                     n: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of ``attr_apply`` (same in-place contract)."""
    kk = k if isinstance(k, torch.Tensor) else int(k)
    counts += kk * cdelta
    cms += kk * sdelta
    if total is not None:
        total[slot:slot + 1] += kk * n


@_build.counted
def attr_apply(counts: torch.Tensor, cdelta: torch.Tensor, cms: torch.Tensor,
               sdelta: torch.Tensor, k: Union[int, torch.Tensor], *,
               total: Optional[torch.Tensor] = None, slot: int = 0,
               n: Optional[torch.Tensor] = None) -> None:
    """In place: ``counts += k·cdelta``, ``cms += k·sdelta`` and
    ``total[slot] += k·n[0]``; ``k`` a host int or a one-element int32
    device tensor (read on the device)."""
    dev = _check_apply(counts, cdelta, cms, sdelta, k, total, slot, n)
    if dev.type == "cpu":
        return attr_apply_plain(counts, cdelta, cms, sdelta, k, total=total,
                                slot=slot, n=n)
    k_dev = k if isinstance(k, torch.Tensor) else None
    k_host = 0 if k_dev is not None else int(k)
    sc = apply_split(counts.shape[0], counts.data_ptr(), cdelta.data_ptr())
    ss = apply_split(cms.numel(), cms.data_ptr(), sdelta.data_ptr())
    plan = apply_plan(sc, ss, _sm_count(dev))
    lib = _build.library("attr_apply", _SIG_APPLY)
    err = lib.attr_apply(
        counts.data_ptr(), cdelta.data_ptr(), counts.shape[0], sc.head,
        plan.blocks_c, cms.data_ptr(), sdelta.data_ptr(), cms.numel(),
        ss.head, plan.blocks_s, _ptr(total, slot), _ptr(n), k_host,
        _ptr(k_dev), plan.threads, int(plan.eager), _stream(dev))
    _build.check(lib, err, "attr_apply")
    _build.note_launch(attr_apply)


def _check_match(rows_list, valid_list, plan_rows, plan_valid, flags, km
                 ) -> torch.device:
    dev = _device_of(plan_rows)
    _vec("plan_rows", plan_rows, torch.int32, dev)
    _vec("plan_valid", plan_valid, torch.bool, dev)
    k = len(rows_list)
    if not 1 <= k <= MAX_STACK or len(valid_list) != k:
        raise ValueError(f"1..{MAX_STACK} entries of rows and valid, got "
                         f"{k} and {len(valid_list)}")
    for r, v in zip(rows_list, valid_list):
        _vec("rows", r, torch.int32, dev)
        _vec("valid", v, torch.bool, dev)
        if r.shape != plan_rows.shape or v.shape != plan_valid.shape:
            raise ValueError("every entry must have the plan's shape")
    _vec("flags", flags, torch.int32, dev)
    _vec("km", km, torch.int32, dev)
    if flags.shape[0] < k or km.shape[0] != 1:
        raise ValueError("flags needs a slot per entry, km one element")
    return dev


def attr_match_plain(rows_list: Sequence[torch.Tensor],
                     valid_list: Sequence[torch.Tensor],
                     plan_rows: torch.Tensor, plan_valid: torch.Tensor,
                     flags: torch.Tensor, km: torch.Tensor) -> None:
    """Plain PyTorch version of ``attr_match``."""
    for e, (r, v) in enumerate(zip(rows_list, valid_list)):
        same = torch.equal(r, plan_rows) and torch.equal(v, plan_valid)
        flags[e] = 0 if same else 1
    km[0] = len(rows_list) - flags[:len(rows_list)].sum()


@_build.counted
def attr_match(rows_list: Sequence[torch.Tensor],
               valid_list: Sequence[torch.Tensor], plan_rows: torch.Tensor,
               plan_valid: torch.Tensor, flags: torch.Tensor,
               km: torch.Tensor) -> None:
    """For each of the k entries (k <= ``MAX_STACK``): ``flags[e] = 0``
    when its rows and valid equal the plan's at every lane, else 1; and
    ``km[0]`` = the number of matching entries.  Nothing is stacked: the
    entries' addresses ride in the kernel's parameters."""
    dev = _check_match(rows_list, valid_list, plan_rows, plan_valid, flags,
                       km)
    if dev.type == "cpu":
        return attr_match_plain(rows_list, valid_list, plan_rows,
                                plan_valid, flags, km)
    k = len(rows_list)
    rows_ptrs = (ctypes.c_int64 * k)(*[r.data_ptr() for r in rows_list])
    valid_ptrs = (ctypes.c_int64 * k)(*[v.data_ptr() for v in valid_list])
    lib = _build.library("attr_apply", _SIG_APPLY)
    # the entries' mismatch mask and the blocks' ticket, zero, and left so
    # by every launch (its last block clears them)
    state = _build.stream_pool(
        "attr_match", dev,
        lambda n: torch.zeros(n, dtype=torch.int32, device=dev), 2)
    err = lib.attr_match(ctypes.addressof(rows_ptrs),
                         ctypes.addressof(valid_ptrs), k,
                         plan_rows.data_ptr(), plan_valid.data_ptr(),
                         plan_rows.shape[0], flags.data_ptr(), km.data_ptr(),
                         state.data_ptr(), _stream(dev))
    if err != 0:
        _build.drop_pool("attr_match", dev)
    _build.check(lib, err, "attr_match")
    _build.note_launch(attr_match)


# -- K9 attr_snapshot ---------------------------------------------------------

def snapshot_size(k: int, n_shards: int) -> int:
    """Length of the int64 vector ``attr_snapshot`` returns."""
    return 3 * k + n_shards + 5


def decode_snapshot(out: np.ndarray, k: int, n_shards: int
                    ) -> Dict[str, object]:
    """The named outputs of an ``attr_snapshot`` vector read back to the
    host: vals, rows, est (int64 [k]), shard (int64 [n_shards]), total,
    nnz, p99 (int) and gini, mean_nz (float32)."""
    out = np.asarray(out, dtype=np.int64)
    tail = out[3 * k + n_shards:]
    return {
        "vals": out[:k], "rows": out[k:2 * k], "est": out[2 * k:3 * k],
        "shard": out[3 * k:3 * k + n_shards],
        "total": int(tail[0]), "nnz": int(tail[1]), "p99": int(tail[2]),
        "gini": np.uint32(tail[3]).view(np.float32),
        "mean_nz": np.uint32(tail[4]).view(np.float32),
    }


def _check_snapshot(counts, cms, seeds, k, n_shards) -> torch.device:
    dev = _device_of(counts)
    _vec("counts", counts, torch.int32, dev)
    _check_sketch(cms, seeds, dev)
    cap = counts.shape[0]
    if not 1 <= k <= cap:
        raise ValueError(f"k must be in 1..{cap}, got {k}")
    if n_shards < 1 or cap % n_shards:
        raise ValueError(f"{n_shards} shards do not divide {cap} rows")
    if cap >= 2**31:
        raise ValueError("rows must fit in int32")
    return dev


def attr_snapshot_plain(counts: torch.Tensor, cms: torch.Tensor,
                        seeds: Sequence[int], k: int,
                        n_shards: int) -> torch.Tensor:
    """Plain PyTorch version of ``attr_snapshot`` (a stable descending
    sort; the Gini sum in float64, the gauges in float32)."""
    cap = counts.shape[0]
    dev = counts.device
    c = counts.to(torch.int64)
    order = torch.sort(counts, descending=True, stable=True).indices
    desc = c[order]
    top = order[:k].to(torch.int32)
    h = cms_hash(top, list(seeds)[:cms.shape[0]], cms.shape[1]).long()
    depth_idx = torch.arange(cms.shape[0], device=dev)[:, None]
    est = cms[depth_idx, h].min(dim=0).values.to(torch.int64)
    total = int(c.sum())
    nnz = int((c > 0).sum())
    j = torch.arange(nnz, dtype=torch.float64, device=dev)
    gsum = float(((nnz - 2.0 * j - 1.0) * desc[:nnz].double()).sum())
    pos = min(max(cap - nnz + ((nnz - 1) * 99) // 100, 0), cap - 1)
    nnz_f = np.float32(max(nnz, 1))
    total_f = np.float32(max(total, 1))
    gini = np.float32(gsum) / (nnz_f * total_f)
    mean = total_f / nnz_f
    tail = torch.tensor(
        [total, nnz, int(desc[cap - 1 - pos]),
         int(np.float32(gini).view(np.uint32)),
         int(np.float32(mean).view(np.uint32))], dtype=torch.int64,
        device=dev)
    return torch.cat([desc[:k], top.to(torch.int64), est,
                      c.view(n_shards, -1).sum(dim=1), tail])


@_build.counted
def attr_snapshot(counts: torch.Tensor, cms: torch.Tensor,
                  seeds: Sequence[int], k: int,
                  n_shards: int = 1) -> torch.Tensor:
    """The snapshot of one counts column and its sketch as one int64
    vector of ``snapshot_size(k, n_shards)`` (see ``decode_snapshot``)."""
    dev = _check_snapshot(counts, cms, seeds, k, n_shards)
    if dev.type == "cpu":
        return attr_snapshot_plain(counts, cms, seeds, k, n_shards)
    cap = counts.shape[0]
    lib = _build.library("attr_snapshot", _SIG_SNAPSHOT)
    nbytes = ctypes.c_int64(0)
    lib.attr_snapshot_scratch(cap, k, n_shards, ctypes.addressof(nbytes))
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    out = torch.empty(snapshot_size(k, n_shards), dtype=torch.int64,
                      device=dev)
    seeds_arr = _seed_array(seeds)
    err = lib.attr_snapshot(
        counts.data_ptr(), cap, cms.data_ptr(), cms.shape[0], cms.shape[1],
        ctypes.addressof(seeds_arr), k, n_shards, scratch.data_ptr(),
        out.data_ptr(), _stream(dev))
    _build.check(lib, err, "attr_snapshot")
    _build.note_launch(attr_snapshot)
    return out

