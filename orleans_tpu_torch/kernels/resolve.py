"""K1 ``resolve_dense``, K2 ``resolve_sorted`` and K10 ``resolve_wide``:
key → row resolution of emitted messages on the device, with the count of
misses.

``resolve_dense`` replaces ``orleans_tpu/tensor/engine.py``
``_resolve_rows_dense_kernel`` (one gather from a dense direct map);
``resolve_sorted`` replaces ``_resolve_rows_kernel`` (a lower-bound binary
search over the sentinel-padded sorted key mirror); ``resolve_wide``
replaces ``_resolve_rows_wide_kernel`` (a 30-bit hash of a wide key's
``(hi, lo)`` int32 words, a lower-bound search over the sorted hashes and
up to ``WIDE_PROBES`` candidates checked against the full words).  All
three return ``rows``
(int32, -1 where the key is padding, invalid or not active) and the miss
count (an int32 scalar tensor: lanes that were valid but did not resolve),
which stays on the device until the engine's miss-check drain reads it.
Given ``misses`` (a one-element int32 tensor on the keys' device), the
count adds into it instead of a fresh zeroed scalar: a fused window sums
every tick's misses into its one device total that way.

What bounds them on an H100 and what the kernels do about it is in the
notes at the top of ``csrc/resolve.cu`` and ``csrc/resolve_wide.cu``; K2
and K10 share their search tree (``csrc/resolve_tree.cuh``) and its plan
(``resolve_plan``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.attr import _M32, _mul32

# Device-path key sentinel: resolve kernels treat any key >= this as
# padding and drop it.  Single definition (re-exported by vector_grain).
KEY_SENTINEL = 2**31 - 1

#: candidates ``resolve_wide`` checks past the lower bound of a key's hash:
#: a run of more than 4 equal 30-bit hashes among live keys is
#: astronomically unlikely, and a key that still misses is redelivered
#: through the exact host path
WIDE_PROBES = 4

#: K1's persistent grid: threads a block, at most this many blocks on
#: each SM (fewer where an SM holds fewer at once)
DENSE_THREADS = 512
DENSE_BLOCKS_PER_SM = 4
#: fresh miss counters handed out from one zeroed block of this many
#: (one fill a block, not one a call: see ``_miss_counter``)
COUNTER_POOL = 1024

_P = ctypes.c_void_p
_SIGNATURES = {
    "resolve_dense": (_P, ctypes.c_int32, _P, _P, _P, _P, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, _P),
    "resolve_sorted": (_P, _P, ctypes.c_int32, _P, _P, _P, _P,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, _P),
}
_SIG_WIDE = {"resolve_wide": (_P, _P, ctypes.c_int32, _P, _P, ctypes.c_int32,
                              ctypes.c_int, _P, _P, _P, _P, _P,
                              ctypes.c_int64,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, _P)}


def _check_vector(name: str, t: torch.Tensor, dtype: torch.dtype,
                  device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, keys on {device}")


def _check_lanes(keys: torch.Tensor, valid: torch.Tensor) -> None:
    _check_vector("keys", keys, torch.int32, keys.device)
    _check_vector("valid", valid, torch.bool, keys.device)
    if valid.shape != keys.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != keys "
                         f"{tuple(keys.shape)}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


# (device, stream) -> [a zeroed pool of counters, the next one to hand out]
_POOLS: Dict[Tuple[torch.device, int], list] = {}


def _fresh_counter(device: torch.device) -> torch.Tensor:
    """A zeroed int32 scalar on ``device``.  On a card it is the next
    unused element of a pool zeroed by one fill (a fill launch per call
    would cost the unfused tick's resolve a kernel of its own, about as
    long as the resolve); no element is handed out twice, and each keeps
    its pool alive.  A pool is zeroed on the stream that uses it.  While a
    CUDA graph captures, the counter is filled in the graph, so every
    replay starts from zero."""
    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return torch.zeros((), dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    pool = _POOLS.get(key)
    if pool is None or pool[1] == COUNTER_POOL:
        pool = _POOLS[key] = [torch.zeros(COUNTER_POOL, dtype=torch.int32,
                                          device=device), 0]
    pool[1] += 1
    return pool[0][pool[1] - 1]


def _miss_counter(misses, keys: torch.Tensor) -> torch.Tensor:
    """A fresh zeroed int32 scalar, or the caller's accumulator."""
    if misses is None:
        return _fresh_counter(keys.device)
    if not isinstance(misses, torch.Tensor) or misses.dtype != torch.int32 \
            or misses.numel() != 1 or misses.device != keys.device:
        raise TypeError("misses must be a one-element int32 tensor on the "
                        "keys' device")
    return misses


def _launch(fn_name: str, rows: torch.Tensor, *args,
            source: str = "resolve", signatures=_SIGNATURES) -> None:
    lib = _build.library(source, signatures)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    _build.check(lib, err, fn_name)


# -- K1 ----------------------------------------------------------------------

def resolve_dense_plain(dense: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, misses=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``resolve_dense``."""
    size = dense.shape[0]
    valid = valid & (keys < KEY_SENTINEL)
    in_range = valid & (keys >= 0) & (keys < size)
    rows = torch.where(in_range, dense[keys.clamp(0, size - 1).long()], -1)
    hit = in_range & (rows >= 0)
    count = _miss_counter(misses, keys)
    count += (hit ^ valid).sum(dtype=torch.int32)
    return rows, count


@_build.counted
def resolve_dense(dense: torch.Tensor, keys: torch.Tensor,
                  valid: torch.Tensor, misses=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rows = dense[key]`` where the lane is valid, the key is below the
    sentinel and ``0 <= key < len(dense)``, else -1; plus the miss count
    (added into ``misses`` when given)."""
    _check_lanes(keys, valid)
    _check_vector("dense", dense, torch.int32, keys.device)
    if dense.shape[0] == 0:
        raise ValueError("dense map is empty")
    if keys.device.type == "cpu":
        return resolve_dense_plain(dense, keys, valid, misses)
    m = keys.shape[0]
    rows = torch.empty(m, dtype=torch.int32, device=keys.device)
    misses = _miss_counter(misses, keys)
    if m:
        _launch("resolve_dense", rows, dense.data_ptr(), dense.shape[0],
                keys.data_ptr(), valid.data_ptr(), rows.data_ptr(),
                misses.data_ptr(), m, DENSE_THREADS, DENSE_BLOCKS_PER_SM)
        _build.note_launch(resolve_dense)
    return rows, misses


# -- K2 ----------------------------------------------------------------------

#: deepest shared-memory search tree K2 builds: 2**12 - 1 = 4,095 keys,
#: 16 KB a block
TREE_LEVELS = 12
#: K2's persistent grid, blocks of 512 threads on each SM: 2 where no
#: lane lifts through L2 (the whole mirror in the tree, or buckets of 8
#: keys read at once), 1 where lanes lift through larger buckets
#: (measured on an H100, see PERF.md)
SORTED_BLOCKS_PER_SM_RUN = 2
SORTED_BLOCKS_PER_SM_LIFT = 1


def resolve_plan(n: int) -> Tuple[bool, int, int, int]:
    """K2's and K10's search plan for a mirror of ``n`` keys: ``(whole,
    levels, log_s, blocks_per_sm)``.  A mirror of at most
    ``2**TREE_LEVELS - 1`` keys goes whole into the shared-memory tree of
    ``2**levels - 1`` nodes; a longer one leaves there one key of each
    bucket of ``s = 2**log_s`` keys (K2 the first key of each bucket
    after the first, ``sorted_keys[(j + 1) * s]``; K10 the last key of
    each, ``sorted_h[(j + 1) * s - 1]``), with ``s >= 8`` the least power
    of two that needs at most ``2**TREE_LEVELS`` buckets; and the grid's
    blocks on each SM."""
    if n < 1:
        raise ValueError("an empty mirror has no plan")
    if n < 1 << TREE_LEVELS:
        return True, max(1, n.bit_length()), 0, SORTED_BLOCKS_PER_SM_RUN
    log_s = max(3, (-(-n >> TREE_LEVELS) - 1).bit_length())
    buckets = -(-n >> log_s)
    return (False, max(1, (buckets - 1).bit_length()), log_s,
            SORTED_BLOCKS_PER_SM_RUN if log_s == 3
            else SORTED_BLOCKS_PER_SM_LIFT)


def resolve_sorted_plain(sorted_keys: torch.Tensor, sorted_rows: torch.Tensor,
                         keys: torch.Tensor, valid: torch.Tensor, misses=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``resolve_sorted``."""
    n = sorted_keys.shape[0]
    valid = valid & (keys < KEY_SENTINEL)
    idx = torch.searchsorted(sorted_keys, keys, side="left").clamp_(0, n - 1)
    hit = (sorted_keys[idx] == keys) & valid
    rows = torch.where(hit, sorted_rows[idx], -1)
    count = _miss_counter(misses, keys)
    count += (hit ^ valid).sum(dtype=torch.int32)
    return rows, count


@_build.counted
def resolve_sorted(sorted_keys: torch.Tensor, sorted_rows: torch.Tensor,
                   keys: torch.Tensor, valid: torch.Tensor, misses=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower-bound search of each key in ``sorted_keys`` (ascending,
    padded with ``KEY_SENTINEL``), clipped to the last index; a lane hits
    when it is valid and the key there equals its own.  Returns
    ``sorted_rows`` at the hit (else -1) and the miss count (added into
    ``misses`` when given)."""
    _check_lanes(keys, valid)
    _check_vector("sorted_keys", sorted_keys, torch.int32, keys.device)
    _check_vector("sorted_rows", sorted_rows, torch.int32, keys.device)
    if sorted_keys.shape != sorted_rows.shape or sorted_keys.shape[0] == 0:
        raise ValueError("sorted_keys/sorted_rows must be equal, non-empty "
                         "vectors")
    if keys.device.type == "cpu":
        return resolve_sorted_plain(sorted_keys, sorted_rows, keys, valid,
                                    misses)
    m = keys.shape[0]
    rows = torch.empty(m, dtype=torch.int32, device=keys.device)
    misses = _miss_counter(misses, keys)
    if m:
        whole, levels, log_s, per_sm = resolve_plan(sorted_keys.shape[0])
        _launch("resolve_sorted", rows, sorted_keys.data_ptr(),
                sorted_rows.data_ptr(), sorted_keys.shape[0],
                keys.data_ptr(), valid.data_ptr(), rows.data_ptr(),
                misses.data_ptr(), m, int(whole), levels, log_s, per_sm)
        _build.note_launch(resolve_sorted)
    return rows, misses


# -- K10 ---------------------------------------------------------------------

def mix32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The 30-bit bucket hash of wide keys' int32 words (``arena.mix32_np``
    and ``engine._mix32_dev`` of the JAX package, computed in uint32
    there): int64 arithmetic masked to 32 bits, each multiply split so no
    product overflows int64."""
    h = _mul32(hi.to(torch.int64) & _M32, 0x85EBCA6B) \
        ^ _mul32(lo.to(torch.int64) & _M32, 0xC2B2AE35)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x27D4EB2F)
    h = h ^ (h >> 13)
    return (h & 0x3FFFFFFF).to(torch.int32)


def _check_wide(sorted_h, rows_by_h, hi_col, lo_col, hi, lo, valid) -> None:
    _check_vector("lo", lo, torch.int32, lo.device)
    _check_vector("valid", valid, torch.bool, lo.device)
    if lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lo.device}")
    if valid.shape != lo.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != keys "
                         f"{tuple(lo.shape)}")
    if hi is not None:
        _check_vector("hi", hi, torch.int32, lo.device)
        if hi.shape != lo.shape:
            raise ValueError(f"hi {tuple(hi.shape)} != lo {tuple(lo.shape)}")
    for name, t in (("sorted_h", sorted_h), ("rows_by_h", rows_by_h)):
        _check_vector(name, t, torch.int32, lo.device)
    if sorted_h.shape != rows_by_h.shape or sorted_h.shape[0] == 0:
        raise ValueError("sorted_h/rows_by_h must be equal, non-empty "
                         "vectors")
    if _interleaved(hi_col, lo_col):
        if hi_col.dtype != torch.int32 or hi_col.device != lo.device:
            raise TypeError("hi_col/lo_col must be int32 on the keys' "
                            "device")
    else:
        for name, t in (("hi_col", hi_col), ("lo_col", lo_col)):
            _check_vector(name, t, torch.int32, lo.device)
    if hi_col.shape != lo_col.shape or hi_col.shape[0] == 0:
        raise ValueError("hi_col/lo_col must be equal, non-empty vectors")


def _interleaved(hi_col: torch.Tensor, lo_col: torch.Tensor) -> bool:
    """``hi_col`` and ``lo_col`` are the two columns of one ``[cap, 2]``
    word array (``GrainArena.device_index_wide``'s layout): 1-D views of
    stride 2, ``lo_col`` one word after ``hi_col``."""
    return (isinstance(hi_col, torch.Tensor)
            and isinstance(lo_col, torch.Tensor)
            and hi_col.dim() == 1 and lo_col.dim() == 1
            and hi_col.stride(0) == 2 and lo_col.stride(0) == 2
            and hi_col.dtype == lo_col.dtype
            and lo_col.data_ptr() == hi_col.data_ptr()
            + hi_col.element_size())


def resolve_wide_plain(sorted_h: torch.Tensor, rows_by_h: torch.Tensor,
                       hi_col: torch.Tensor, lo_col: torch.Tensor,
                       hi: Optional[torch.Tensor], lo: torch.Tensor,
                       valid: torch.Tensor, misses=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``resolve_wide``."""
    if hi is None:
        valid = valid & (lo < KEY_SENTINEL)
        hi = torch.zeros_like(lo)
    h = mix32(hi, lo)
    n, cap = sorted_h.shape[0], hi_col.shape[0]
    idx = torch.searchsorted(sorted_h, h, side="left")
    rows = torch.full_like(lo, -1)
    for k in range(WIDE_PROBES):
        j = (idx + k).clamp_(0, n - 1)
        cand = rows_by_h[j]
        cr = cand.clamp(0, cap - 1)
        ok = valid & (sorted_h[j] == h) & (cand >= 0) \
            & (hi_col[cr] == hi) & (lo_col[cr] == lo)
        rows = torch.where((rows < 0) & ok, cand, rows)
    hit = (rows >= 0) & valid
    count = _miss_counter(misses, lo)
    count += (hit ^ valid).sum(dtype=torch.int32)
    return rows, count


@_build.counted
def resolve_wide(sorted_h: torch.Tensor, rows_by_h: torch.Tensor,
                 hi_col: torch.Tensor, lo_col: torch.Tensor,
                 hi: Optional[torch.Tensor], lo: torch.Tensor,
                 valid: torch.Tensor, misses=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve wide keys ``(hi, lo)`` against the wide mirror
    ``(sorted_h, rows_by_h, hi_col, lo_col)`` of ``GrainArena.
    device_index_wide``: the row of the first of the ``WIDE_PROBES``
    entries from the lower bound of the key's hash whose row holds both
    words, where the lane is valid, else -1; plus the miss count (added
    into ``misses`` when given).  ``hi=None`` resolves int32 keys ``lo``
    as the wide keys ``(0, lo)``, keys at or above the sentinel being
    padding."""
    _check_wide(sorted_h, rows_by_h, hi_col, lo_col, hi, lo, valid)
    if lo.device.type == "cpu":
        return resolve_wide_plain(sorted_h, rows_by_h, hi_col, lo_col, hi,
                                  lo, valid, misses)
    m = lo.shape[0]
    rows = torch.empty(m, dtype=torch.int32, device=lo.device)
    misses = _miss_counter(misses, lo)
    if m:
        whole, levels, log_s, per_sm = resolve_plan(sorted_h.shape[0])
        _launch("resolve_wide", rows, sorted_h.data_ptr(),
                rows_by_h.data_ptr(), sorted_h.shape[0], hi_col.data_ptr(),
                lo_col.data_ptr(), hi_col.shape[0],
                2 if _interleaved(hi_col, lo_col) else 1,
                None if hi is None else hi.data_ptr(), lo.data_ptr(),
                valid.data_ptr(), rows.data_ptr(), misses.data_ptr(), m,
                int(whole), levels, log_s, per_sm, source="resolve_wide",
                signatures=_SIG_WIDE)
        _build.note_launch(resolve_wide)
    return rows, misses
