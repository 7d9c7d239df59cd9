"""The cross-shard exchange's kernels (tensor/exchange.py).

Lanes are ``rows`` int32 ``[m]`` and ``mask`` bool ``[m]``, padded
conceptually to ``n * L`` (lanes ``>= m`` are invalid).  Lane ``i`` lies in
source chunk ``i // L``; a valid lane (mask set, ``0 <= row < n *
shard_capacity``) is bound for block ``row // shard_capacity``, local when
that is its chunk and cross otherwise.

K23 ``exchange_classify`` replaces ``orleans_tpu/tensor/exchange.py``
``classify_lanes`` + ``demand_per_dest`` (:83-108) as the disengaged probe
and the cap-0 paths run them.  ``mode="probe"`` returns the stats int32
``[3 + 2n]`` = (Σcross, 0, Σvalid, g, g), ``g[d]`` the cross lanes bound
for block ``d``; ``mode="cap0"`` returns ``(where(local, rows, -1), local,
cross, stats)`` over the ``n * L`` lanes, stats = (0, Σcross, Σlocal, g,
g).

K24 ``exchange_buckets`` replaces the two ``shard_map`` bodies of
``ShardExchange`` (``_traced`` :656-733, ``_traced_perdest`` :772-861) with
their collectives folded into the write: receiver ``d``'s region of the
output is lanes ``[d * W, (d + 1) * W)``; its first ``L`` lanes are chunk
``d`` in place (leaves copied, the row kept where local), then the
buckets.  ``cap`` gives the legacy layout (``W = L + n * cap``: chunk
``s``'s lane of stable rank ``pos`` among its lanes bound for ``d`` goes
to ``L + s * cap + pos`` when ``pos < cap``); ``caps`` and ``R`` the
per-destination one (``W = L + R``: it goes to ``L + Σ_{s' < s}
min(need[s'][d], caps[d]) + pos`` when ``pos < caps[d]`` and that rank is
below ``R``).  Every other cross lane is dropped (``dropped`` bool ``[m]``,
input lane order).  Returns ``(rows [n W], leaves [n W, ...], mask [n W],
dropped [m], stats)``, stats = (Σcross, Σdropped, Σvalid - Σdropped, max_s
need, Σ_s need).  Every payload leaf — any trailing shape and type — moves
in one call.  K24 is three CUDA launches (histogram, scan, write with the
fill of the empty bucket lanes); its counter counts one per call.

The plain versions reproduce the JAX bodies step by step (a stable
``torch.argsort``, ``searchsorted`` and a scatter); a CPU tensor takes
them, a CUDA tensor launches the kernel or raises.  Kernel and plain
version agree bit for bit.  What bounds each kernel on an H100 and what
its design does about it is in the note at the top of
``csrc/exchange.cu``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from orleans_tpu_torch.kernels import _build

#: shard blocks the kernels take (``kMaxShards`` in ``csrc/exchange.cu``)
MAX_SHARDS = 64
#: payload leaves one K24 call moves (``kMaxLeaves``)
MAX_LEAVES = 32

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "exchange_classify": (_P, _P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P,
                          _P, _P),
    "exchange_buckets_scratch": (_I64, _I32),
    "exchange_buckets": (_P, _P, _I64, _I64, _I32, _I32, _I32, _P, _I32,
                         _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
}


def _table(values, ctype) -> ctypes.Array:
    return (ctype * max(1, len(values)))(*values)


def _unit(*quantities: int) -> int:
    """The widest unit (16, 8, 4 or 1 bytes) dividing every quantity."""
    for u in (16, 8, 4):
        if all(q % u == 0 for q in quantities):
            return u
    return 1


def _pad(x: torch.Tensor, total: int, fill) -> torch.Tensor:
    if x.shape[0] == total:
        return x
    return torch.cat([x, x.new_full((total - x.shape[0], *x.shape[1:]),
                                    fill)])


def _check(rows: torch.Tensor, mask: torch.Tensor, shard_capacity: int,
           L: int, n: int) -> None:
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 \
            or rows.dim() != 1 or not rows.is_contiguous():
        raise TypeError("rows must be a contiguous 1-D int32 tensor")
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool \
            or mask.shape != rows.shape or not mask.is_contiguous():
        raise TypeError("mask must be a contiguous bool tensor shaped like "
                        "rows")
    if mask.device != rows.device:
        raise ValueError(f"mask on {mask.device}, rows on {rows.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"{n} shard blocks: the kernels take 1.."
                         f"{MAX_SHARDS}")
    if L < 1 or shard_capacity < 1 or rows.shape[0] > n * L \
            or n * L >= 2**31:
        raise ValueError(f"{rows.shape[0]} lanes do not fit {n} chunks of "
                         f"{L} below 2**31 lanes (shard capacity "
                         f"{shard_capacity})")
    if n * shard_capacity >= 2**31:
        raise ValueError("the arena's rows must fit int32")


# -- the classification algebra (plain) ---------------------------------------

def classify_lanes(rows: torch.Tensor, mask: torch.Tensor,
                   shard_capacity: int, L: int, n: int):
    """``(valid, dest, local, cross)`` of padded lanes, as the JAX
    ``classify_lanes``; rows past the arena (``>= n * shard_capacity``)
    count as invalid."""
    m_pad = rows.shape[0]
    chunk = torch.arange(m_pad, dtype=torch.int64, device=rows.device) // L
    valid = mask & (rows >= 0) & (rows < n * shard_capacity)
    dest = torch.where(valid, rows.to(torch.int64) // shard_capacity,
                       torch.full_like(chunk, n))
    local = valid & (dest == chunk)
    cross = valid & ~local
    return valid, dest, local, cross


def demand_per_dest(cross: torch.Tensor, dest: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Cross lanes per destination block (int32 ``[n]``), the segment sum of
    the JAX ``demand_per_dest``."""
    seg = torch.where(cross, dest, torch.full_like(dest, n))
    return torch.zeros(n + 1, dtype=torch.int32, device=cross.device) \
        .index_add_(0, seg, cross.to(torch.int32))[:n]


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).sum().to(torch.int32).reshape(1)


# -- K23 ----------------------------------------------------------------------

def exchange_classify_plain(rows: torch.Tensor, mask: torch.Tensor,
                            shard_capacity: int, L: int, n: int,
                            mode: str = "probe"):
    """Plain PyTorch version of ``exchange_classify``."""
    m_pad = n * L
    rows_p = _pad(rows, m_pad, -1)
    mask_p = _pad(mask, m_pad, False)
    valid, dest, local, cross = classify_lanes(rows_p, mask_p,
                                               shard_capacity, L, n)
    g = demand_per_dest(cross, dest, n)
    zero = torch.zeros(1, dtype=torch.int32, device=rows.device)
    if mode == "probe":
        return torch.cat([_count(cross), zero, _count(valid), g, g])
    stats = torch.cat([zero, _count(cross), _count(local), g, g])
    return (torch.where(local, rows_p, torch.full_like(rows_p, -1)),
            local, cross, stats)


@_build.counted
def exchange_classify(rows: torch.Tensor, mask: torch.Tensor,
                      shard_capacity: int, L: int, n: int,
                      mode: str = "probe"):
    """K23: the probe's stats, or the cap-0 outputs and stats (see the
    module note)."""
    if mode not in ("probe", "cap0"):
        raise ValueError(f"mode {mode!r}: 'probe' or 'cap0'")
    _check(rows, mask, shard_capacity, L, n)
    if rows.device.type == "cpu":
        return exchange_classify_plain(rows, mask, shard_capacity, L, n,
                                       mode)
    dev = rows.device
    stats = torch.empty(3 + 2 * n, dtype=torch.int32, device=dev)
    cap0 = mode == "cap0"
    if cap0:
        out_rows = torch.empty(n * L, dtype=torch.int32, device=dev)
        local = torch.empty(n * L, dtype=torch.bool, device=dev)
        cross = torch.empty(n * L, dtype=torch.bool, device=dev)
        ptrs = (out_rows.data_ptr(), local.data_ptr(), cross.data_ptr())
    else:
        ptrs = (None, None, None)
    lib = _build.library("exchange", _SIGNATURES)
    err = lib.exchange_classify(
        rows.data_ptr(), mask.data_ptr(), rows.shape[0], L, n,
        shard_capacity, int(cap0), stats.data_ptr(), *ptrs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "exchange_classify")
    _build.note_launch(exchange_classify)
    if cap0:
        return out_rows, local, cross, stats
    return stats


# -- K24 ----------------------------------------------------------------------

def _check_leaves(leaves: Sequence[torch.Tensor], rows: torch.Tensor
                  ) -> None:
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"{len(leaves)} payload leaves: K24 takes at most "
                         f"{MAX_LEAVES}")
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1 \
                or leaf.shape[0] != rows.shape[0]:
            raise TypeError(f"leaf {i} must be a tensor with {rows.shape[0]}"
                            f" lanes on its leading axis")
        if leaf.device != rows.device:
            raise ValueError(f"leaf {i} on {leaf.device}, rows on "
                             f"{rows.device}")


def _check_plan(n: int, cap: Optional[int], caps: Optional[Sequence[int]],
                R: Optional[int]) -> None:
    if caps is None:
        if cap is None or cap < 1:
            raise ValueError(f"legacy layout needs cap >= 1, got {cap} "
                             f"(cap 0 is K23's)")
    elif len(caps) != n or min(caps) < 0 or R is None or R < 1:
        raise ValueError(f"per-destination layout needs {n} caps >= 0 and "
                         f"R >= 1, got {caps}, {R}")


def exchange_buckets_plain(rows: torch.Tensor, mask: torch.Tensor,
                           leaves: Sequence[torch.Tensor],
                           shard_capacity: int, L: int, n: int,
                           cap: Optional[int] = None,
                           caps: Optional[Sequence[int]] = None,
                           R: Optional[int] = None):
    """Plain PyTorch version of ``exchange_buckets``: the JAX per-shard
    bodies, vectorised over the n chunks (a stable argsort per chunk, the
    per-destination starts by searchsorted, one scatter per output)."""
    dev = rows.device
    m = rows.shape[0]
    m_pad = n * L
    rows_p = _pad(rows, m_pad, -1)
    mask_p = _pad(mask, m_pad, False)
    leaves_p = [_pad(x, m_pad, 0) for x in leaves]
    valid, dest, local, cross = classify_lanes(rows_p, mask_p,
                                               shard_capacity, L, n)
    valid, dest, local, cross = (x.view(n, L)
                                 for x in (valid, dest, local, cross))
    s_idx = torch.arange(n, dtype=torch.int64, device=dev).view(n, 1)
    sdest_in = torch.where(cross, dest, torch.full_like(dest, n))
    # need[s][d]: the lanes of chunk s bound for d, overflow included
    need = torch.zeros(n * (n + 1), dtype=torch.int64, device=dev) \
        .index_add_(0, (s_idx * (n + 1) + sdest_in).reshape(-1),
                    torch.ones(m_pad, dtype=torch.int64, device=dev)) \
        .view(n, n + 1)[:, :n]
    order = torch.argsort(sdest_in, dim=1, stable=True)
    sdest = torch.gather(sdest_in, 1, order)
    start = torch.searchsorted(
        sdest, torch.arange(n, dtype=torch.int64, device=dev)
        .expand(n, n).contiguous())
    sdest_c = sdest.clamp(0, n - 1)
    pos = torch.arange(L, dtype=torch.int64, device=dev).view(1, L) \
        - torch.gather(start, 1, sdest_c)
    if caps is None:
        W = L + n * cap
        fits = (sdest < n) & (pos < cap)
        slot = sdest * W + L + s_idx * cap + pos
        dropped_sorted = (sdest < n) & ~fits
    else:
        W = L + R
        caps_v = torch.as_tensor(list(caps), dtype=torch.int64, device=dev)
        fits = (sdest < n) & (pos < caps_v[sdest_c])
        fills = torch.minimum(need, caps_v.view(1, n))
        before = torch.cumsum(fills, dim=0) - fills  # exclusive over s
        rank = torch.gather(before, 1, sdest_c) + pos
        recv_drop = fits & (rank >= R)
        fits = fits & ~recv_drop
        slot = sdest * W + L + rank
        dropped_sorted = ((sdest < n) & ~fits)
    trash = n * W  # one spare lane takes every lane that goes nowhere
    slot = torch.where(fits, slot, torch.full_like(slot, trash)).reshape(-1)
    own = (s_idx * W + torch.arange(L, dtype=torch.int64, device=dev)
           .view(1, L)).reshape(-1)
    flat_order = (s_idx * L + order).reshape(-1)
    out_rows = torch.full((trash + 1,), -1, dtype=torch.int32, device=dev)
    out_rows[own] = torch.where(local.reshape(-1), rows_p,
                                torch.full_like(rows_p, -1))
    out_rows[slot] = rows_p[flat_order]
    out_rows = out_rows[:trash]
    out_leaves: List[torch.Tensor] = []
    for x in leaves_p:
        out = torch.zeros((trash + 1, *x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[own] = x
        out[slot] = x[flat_order]
        out_leaves.append(out[:trash])
    dropped = torch.zeros((n, L), dtype=torch.bool, device=dev) \
        .scatter_(1, order, dropped_sorted).reshape(-1)[:m]
    n_dropped = dropped_sorted.to(torch.int32).sum().to(torch.int32)
    stats = torch.cat([
        _count(cross), n_dropped.reshape(1),
        (_count(valid) - n_dropped).reshape(1),
        need.max(dim=0).values.to(torch.int32),
        need.sum(dim=0).to(torch.int32)])
    return out_rows, out_leaves, out_rows >= 0, dropped, stats


@_build.counted
def exchange_buckets(rows: torch.Tensor, mask: torch.Tensor,
                     leaves: Sequence[torch.Tensor], shard_capacity: int,
                     L: int, n: int, cap: Optional[int] = None,
                     caps: Optional[Sequence[int]] = None,
                     R: Optional[int] = None):
    """K24: the bucketed exchange, legacy (``cap``) or per-destination
    (``caps``, ``R``) layout (see the module note)."""
    leaves = list(leaves)
    _check(rows, mask, shard_capacity, L, n)
    _check_leaves(leaves, rows)
    _check_plan(n, cap, caps, R)
    if rows.device.type == "cpu":
        return exchange_buckets_plain(rows, mask, leaves, shard_capacity, L,
                                      n, cap=cap, caps=caps, R=R)
    dev = rows.device
    m = rows.shape[0]
    W = L + (n * cap if caps is None else R)
    leaves = [x.contiguous() for x in leaves]
    out_rows = torch.empty(n * W, dtype=torch.int32, device=dev)
    out_mask = torch.empty(n * W, dtype=torch.bool, device=dev)
    dropped = torch.empty(m, dtype=torch.bool, device=dev)
    stats = torch.empty(3 + 2 * n, dtype=torch.int32, device=dev)
    outs = [torch.empty((n * W, *x.shape[1:]), dtype=x.dtype, device=dev)
            for x in leaves]
    row_bytes = [x.element_size() * math.prod(x.shape[1:]) for x in leaves]
    units = [_unit(x.data_ptr(), o.data_ptr(), rb)
             for x, o, rb in zip(leaves, outs, row_bytes)]
    lib = _build.library("exchange", _SIGNATURES)
    words = lib.exchange_buckets_scratch(L, n)
    if words < 0:
        raise ValueError(f"exchange_buckets: scratch for L={L}, n={n} "
                         f"exceeds int32")
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    caps_t = _table([int(c) for c in caps] if caps is not None else [],
                    ctypes.c_int32)
    err = lib.exchange_buckets(
        rows.data_ptr(), mask.data_ptr(), m, L, n, shard_capacity,
        -1 if caps is not None else int(cap), caps_t,
        int(R) if caps is not None else 0, len(leaves),
        _table([x.data_ptr() for x in leaves], ctypes.c_int64),
        _table([o.data_ptr() for o in outs], ctypes.c_int64),
        _table(row_bytes, ctypes.c_int64), _table(units, ctypes.c_int32),
        scratch.data_ptr(), out_rows.data_ptr(), out_mask.data_ptr(),
        dropped.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "exchange_buckets")
    _build.note_launch(exchange_buckets)
    return out_rows, outs, out_mask, dropped, stats
