"""The durable state plane's kernels.

K19 ``pin_columns``: a copy of every given column into its own buffer in
one launch (replaces ``orleans_tpu/tensor/checkpoint.py`` ``_pin_tree``;
also the counts pin of ``_commit_snapshot`` and the journal's copy of a
batch's device leaves on append).  Each column splits into a 16-byte body
and a 1-byte tail (4-byte units where a pointer is only 4-byte aligned);
one launch takes up to 32 such segments, a larger set more launches.

K20 ``gather_columns``: ``col[clip(idx, 0, n - 1)]`` for every pinned
column of an arena in one launch (replaces ``_gather_tree``), the outputs
packed into one uint8 staging buffer at 16-byte aligned offsets, so one
device-to-host copy fetches the chunk (``fetch_packed``).  Pad lanes read
row 0; the caller slices them off.

K21 ``dirty_mask``: ``live & ((counts != pinned) | max(clock_dev,
clock_host) >= cutoff)``, the delta's dirty rows (replaces
``_dirty_mask_kernel``); with ``counts`` None the counts term drops
(``_touched_mask_kernel``).

All three are exact: each kernel and its plain version agree bit for bit.
What bounds each kernel on an H100 and what its design does about it is in
the note at the top of ``csrc/checkpoint.cu``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels import _build

MAX_SEGMENTS = 32
_ALIGN = 16

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {
    "pin_columns": (_I32, _P, _P, _P, _P, _P),
    "gather_columns": (_I32, _P, _P, _P, _P, _P, _I64, _I64, _P, _P),
    "dirty_mask": (_P, _P, _P, _P, _P, _I32, _P, _I64, _P),
}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _table(values, ctype) -> ctypes.Array:
    return (ctype * len(values))(*values)


def _unit(*quantities: int) -> int:
    """The widest unit (16, 4 or 1 bytes) dividing every quantity (the
    addresses and byte counts a unit copy touches)."""
    for u in (16, 4):
        if all(q % u == 0 for q in quantities):
            return u
    return 1


def _check_column(t, what: str) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_contiguous():
        raise TypeError(f"{what} must be a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


# -- K19 ------------------------------------------------------------------

def _check_pin(columns: Sequence[torch.Tensor],
               out: Sequence[torch.Tensor]) -> None:
    if len(columns) != len(out):
        raise ValueError("pin_columns: one output per column")
    for i, (c, o) in enumerate(zip(columns, out)):
        _check_column(c, f"column {i}")
        _check_column(o, f"output {i}")
        if c.dtype != o.dtype or c.shape != o.shape:
            raise ValueError(f"pin_columns: output {i} "
                             f"{tuple(o.shape)}/{o.dtype} != column "
                             f"{tuple(c.shape)}/{c.dtype}")
        if c.device != o.device or c.device != columns[0].device:
            raise ValueError("pin_columns: every column and output must "
                             "share one device")


def pin_columns_plain(columns: Sequence[torch.Tensor],
                      out: Optional[Sequence[torch.Tensor]] = None
                      ) -> List[torch.Tensor]:
    """Plain PyTorch version of ``pin_columns``."""
    if out is None:
        return [c.clone() for c in columns]
    for c, o in zip(columns, out):
        o.copy_(c)
    return list(out)


def _segments(columns: Sequence[torch.Tensor],
              out: Sequence[torch.Tensor]) -> List[Tuple[int, int, int, int]]:
    """(src, dst, units, unit bytes) segments: a body of the widest unit
    both pointers allow and a 1-byte tail."""
    segs = []
    for c, o in zip(columns, out):
        nbytes = c.numel() * c.element_size()
        if nbytes == 0:
            continue
        src, dst = c.data_ptr(), o.data_ptr()
        u = _unit(src, dst)
        body = nbytes // u
        if body:
            segs.append((src, dst, body, u))
        tail = nbytes - body * u
        if tail:
            segs.append((src + body * u, dst + body * u, tail, 1))
    return segs


@_build.counted
def pin_columns(columns: Sequence[torch.Tensor],
                out: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
    """Copies of ``columns`` (into ``out`` where given, else into new
    tensors), all in one launch per 32 segments; returns the copies."""
    columns = list(columns)
    if out is None:
        out = [torch.empty_like(c) for c in columns]
    out = list(out)
    _check_pin(columns, out)
    if not columns or columns[0].device.type == "cpu":
        return pin_columns_plain(columns, out)
    segs = _segments(columns, out)
    lib = _build.library("checkpoint", _SIGNATURES)
    stream = _stream(columns[0])
    for i in range(0, len(segs), MAX_SEGMENTS):
        part = segs[i:i + MAX_SEGMENTS]
        err = lib.pin_columns(
            len(part), _table([s[0] for s in part], ctypes.c_int64),
            _table([s[1] for s in part], ctypes.c_int64),
            _table([s[2] for s in part], ctypes.c_int64),
            _table([s[3] for s in part], ctypes.c_int32), stream)
        _build.check(lib, err, "pin_columns")
        _build.note_launch(pin_columns)
    return out


# -- K20 ------------------------------------------------------------------

def packed_layout(columns: Sequence[torch.Tensor], m: int
                  ) -> Tuple[List[int], int]:
    """Byte offsets of each column's ``[m, ...]`` output in one staging
    buffer (16-byte aligned) and the buffer's size."""
    offs, end = [], 0
    for c in columns:
        offs.append(end)
        row = c[0].numel() * c.element_size() if c.shape[0] else 0
        end = -(-(end + m * row) // _ALIGN) * _ALIGN
    return offs, end


def packed_views(staging: torch.Tensor, columns: Sequence[torch.Tensor],
                 offs: Sequence[int], m: int) -> List[torch.Tensor]:
    """The ``[m, *width]`` outputs of each column inside ``staging``."""
    out = []
    for c, off in zip(columns, offs):
        nbytes = m * c[0].numel() * c.element_size()
        out.append(staging[off:off + nbytes].view(c.dtype).view(
            m, *c.shape[1:]))
    return out


def _check_gather(columns: Sequence[torch.Tensor], idx: torch.Tensor
                  ) -> None:
    if not columns:
        raise ValueError("gather_columns: no columns")
    n = columns[0].shape[0] if columns[0].dim() else 0
    for i, c in enumerate(columns):
        _check_column(c, f"column {i}")
        if c.dim() < 1 or c.shape[0] != n:
            raise ValueError("gather_columns: every column needs the same "
                             "row count")
        if c.device != columns[0].device:
            raise ValueError("gather_columns: columns on several devices")
    if n == 0:
        raise ValueError("gather_columns: no rows to gather from")
    if len(columns) > MAX_SEGMENTS:
        raise ValueError(f"gather_columns takes at most {MAX_SEGMENTS} "
                         f"columns")
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32 \
            or idx.dim() != 1 or not idx.is_contiguous():
        raise TypeError("idx must be a contiguous 1-D int32 tensor")
    if idx.device != columns[0].device:
        raise ValueError(f"idx on {idx.device}, columns on "
                         f"{columns[0].device}")


def gather_columns_plain(columns: Sequence[torch.Tensor], idx: torch.Tensor
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Plain PyTorch version of ``gather_columns`` (the same packed
    layout)."""
    m = idx.shape[0]
    offs, size = packed_layout(columns, m)
    staging = torch.zeros(size, dtype=torch.uint8, device=idx.device)
    views = packed_views(staging, columns, offs, m)
    rows = idx.clamp(0, columns[0].shape[0] - 1).long()
    for c, v in zip(columns, views):
        v.copy_(c.index_select(0, rows))
    return staging, views


@_build.counted
def gather_columns(columns: Sequence[torch.Tensor], idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Every column's rows ``clip(idx, 0, n - 1)`` in one launch: returns
    the uint8 staging buffer and each column's ``[m, *width]`` view into
    it."""
    columns = list(columns)
    _check_gather(columns, idx)
    if idx.device.type == "cpu":
        return gather_columns_plain(columns, idx)
    m = idx.shape[0]
    offs, size = packed_layout(columns, m)
    staging = torch.empty(size, dtype=torch.uint8, device=idx.device)
    views = packed_views(staging, columns, offs, m)
    if m == 0:
        return staging, views
    base = staging.data_ptr()
    units, per_row = [], []
    for c, off in zip(columns, offs):
        row = c[0].numel() * c.element_size()
        u = _unit(c.data_ptr(), base + off, row)
        units.append(u)
        per_row.append(row // u)
    lib = _build.library("checkpoint", _SIGNATURES)
    err = lib.gather_columns(
        len(columns), _table([c.data_ptr() for c in columns], ctypes.c_int64),
        _table(offs, ctypes.c_int64), _table(per_row, ctypes.c_int32),
        _table(units, ctypes.c_int32), idx.data_ptr(), m,
        columns[0].shape[0], base, _stream(idx))
    _build.check(lib, err, "gather_columns")
    _build.note_launch(gather_columns)
    return staging, views


def fetch_packed(staging: torch.Tensor, columns: Sequence[torch.Tensor],
                 m: int) -> List[np.ndarray]:
    """One device-to-host copy of a packed staging buffer into pinned host
    memory, one wait, then numpy views of each column's ``[m, ...]``
    output (``columns`` give the dtypes and widths)."""
    if staging.device.type == "cuda":
        host = torch.empty(staging.shape, dtype=torch.uint8,
                           pin_memory=True)
        host.copy_(staging, non_blocking=True)
        torch.cuda.current_stream(staging.device).synchronize()
    else:
        host = staging
    offs, _ = packed_layout(columns, m)
    return [v.numpy() for v in packed_views(host, columns, offs, m)]


def fetch_columns(columns: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Whole tensors to the host with one copy: K19 packs them into one
    staging buffer on the card, then ``fetch_packed``.  On the CPU,
    copies."""
    columns = [c.reshape(1, *c.shape) for c in columns]
    if not columns:
        return []
    if columns[0].device.type == "cpu":
        return [c[0].clone().numpy() for c in columns]
    offs, size = packed_layout(columns, 1)
    staging = torch.empty(size, dtype=torch.uint8, device=columns[0].device)
    pin_columns(columns, packed_views(staging, columns, offs, 1))
    return [a[0] for a in fetch_packed(staging, columns, 1)]


# -- K21 ------------------------------------------------------------------

def _vector(t, dtype: torch.dtype, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype \
            or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{what} must be a contiguous 1-D {dtype} tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_dirty(counts, pinned, clock_dev, clock_host, live,
                 cutoff) -> None:
    if (counts is None) != (pinned is None):
        raise ValueError("dirty_mask: counts and pinned come together")
    _vector(clock_dev, torch.int32, "clock_dev")
    _vector(clock_host, torch.int32, "clock_host")
    _vector(live, torch.bool, "live")
    tensors = [clock_host, live]
    if counts is not None:
        _vector(counts, torch.int32, "counts")
        _vector(pinned, torch.int32, "pinned")
        tensors += [counts, pinned]
    for t in tensors:
        if t.shape != clock_dev.shape or t.device != clock_dev.device:
            raise ValueError("dirty_mask: every input must share one shape "
                             "and one device")
    if not -2**31 < int(cutoff) < 2**31:
        raise OverflowError(f"cutoff {cutoff} outside the clipped int32 "
                            f"range")


def dirty_mask_plain(counts: Optional[torch.Tensor],
                     pinned: Optional[torch.Tensor],
                     clock_dev: torch.Tensor, clock_host: torch.Tensor,
                     live: torch.Tensor, cutoff: int) -> torch.Tensor:
    """Plain PyTorch version of ``dirty_mask``."""
    dirty = torch.maximum(clock_dev, clock_host) >= int(cutoff)
    if counts is not None:
        dirty = dirty | (counts != pinned)
    return live & dirty


@_build.counted
def dirty_mask(counts: Optional[torch.Tensor], pinned: Optional[torch.Tensor],
               clock_dev: torch.Tensor, clock_host: torch.Tensor,
               live: torch.Tensor, cutoff: int) -> torch.Tensor:
    """The bool mask of rows live and moved since the pin: their traffic
    count changed (``counts`` against ``pinned``; both None for the
    clock-only form) or a use clock reached ``cutoff``."""
    _check_dirty(counts, pinned, clock_dev, clock_host, live, cutoff)
    if clock_dev.device.type == "cpu":
        return dirty_mask_plain(counts, pinned, clock_dev, clock_host, live,
                                cutoff)
    n = clock_dev.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=clock_dev.device)
    if n == 0:
        return out
    lib = _build.library("checkpoint", _SIGNATURES)
    err = lib.dirty_mask(
        counts.data_ptr() if counts is not None else None,
        pinned.data_ptr() if pinned is not None else None,
        clock_dev.data_ptr(), clock_host.data_ptr(), live.data_ptr(),
        int(cutoff), out.data_ptr(), n, _stream(clock_dev))
    _build.check(lib, err, "dirty_mask")
    _build.note_launch(dirty_mask)
    return out
