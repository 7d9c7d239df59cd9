"""K3 ``row_scatter``: ``column[rows] = v`` / ``+= v`` / ``max= v`` in
place, dropping every lane whose row is ``< 0`` or ``>= len(column)``.

Replaces ``orleans_tpu/tensor/vector_grain.py`` ``scatter_rows`` /
``scatter_add_rows`` and ``orleans_tpu/tensor/arena.py`` ``_touch_kernel``.
A bare ``index_put_`` would wrap row -1 onto the last row and silently
corrupt whichever grain lives there; both versions here drop it.

``values`` is a tensor ``[m, *column.shape[1:]]`` of the column's dtype,
a 0-d tensor of that dtype on the column's device, or a host scalar
(Python or numpy).  Both scalars broadcast to every lane without
materialising a lane vector (the heartbeat's ``tick``): a host scalar
rides as a kernel argument, a device scalar is read through its pointer,
which is what a fused window's CUDA graph needs (a replay reads the tick
copied into the graph's input buffer, not the one baked at capture).
SET with duplicate rows keeps one of the writers, not a chosen one.

``scatter_plan`` picks the kernel's path from shapes alone (a CUDA graph
bakes the launch): direct global atomics, combined first among the lanes
of a warp that share a word, or, for ADD and MAX onto few words, a copy of
the column privatized in each block's shared memory and combined over a
thread-block cluster.  What bounds the kernel on an H100 and what it does
about it is in the note at the top of ``csrc/scatter.cu``.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Union

import numpy as np
import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.segment import (
    SEG_BLOCK_BYTES,
    SEG_CLUSTER,
    SegPlan,
)

OPS = {"set": 0, "add": 1, "max": 2}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "row_scatter_i32": (_P, _I64, _P, _I64, _I64, _P, _I64,
                        ctypes.c_int32, _INT, _INT, _I64, _INT, _INT, _P),
    "row_scatter_f32": (_P, _I64, _P, _I64, _I64, _P, _I64, ctypes.c_float,
                        _INT, _INT, _I64, _INT, _INT, _P),
    "row_scatter_init": (),
}
_FN = {torch.int32: "row_scatter_i32", torch.float32: "row_scatter_f32"}

Values = Union[torch.Tensor, numbers.Number, np.generic, np.ndarray]

#: elements per column word from which ADD and MAX are privatized: on an
#: H100 the direct path wins at 16 lanes a word and loses at 32, for ADD,
#: MAX and the touch alike, the times crossing near 20
#: (``probe_k1_k3.py --sweep``, PERF.md)
SCATTER_MIN_PER_WORD = 20
#: threads a block and at most this many blocks on each SM (fewer where an
#: SM holds fewer at once): direct, privatized (K4's)
SCATTER_DIRECT = (256, 8)
SCATTER_PRIVATE = (512, 2)


def scatter_plan(m: int, n: int, inner: int, op: str,
                 scalar: bool) -> SegPlan:
    """K3's path from shapes alone: ``m`` lanes of ``inner`` elements into
    a column of ``n`` rows under ``op``, the value a broadcast scalar
    (``scalar``) or each lane's own.  The plan has K4's fields
    (``SegPlan``): ``cluster`` 0 for a direct path, else every block holds
    a copy of ``cluster * chunk`` column words.

    SET is always direct.  ADD and MAX (of lane values, or of a broadcast
    scalar: the touch, whose block copies are masks of touched words) are
    privatized where the ``m * inner`` elements put at least
    ``SCATTER_MIN_PER_WORD`` (20) on each of the ``n * inner`` column
    words, that is ``m / n`` lanes a row, and the column's words (4 bytes
    each) fit ``SEG_BLOCK_BYTES``, K4's 128 KiB of a block's shared
    memory; then clusters of ``SEG_CLUSTER`` blocks, as K4's.  Else
    direct.  ``scalar`` names the touch; on an H100 its two paths cross
    where ADD's and MAX's do, so it takes their threshold."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    words = n * inner
    if op == "set" or words == 0 or m * inner < SCATTER_MIN_PER_WORD * words \
            or 4 * words > SEG_BLOCK_BYTES:
        return SegPlan(0, 0, *SCATTER_DIRECT)
    chunk = -(-words // SEG_CLUSTER)
    return SegPlan(SEG_CLUSTER, -(-chunk // 4) * 4, *SCATTER_PRIVATE)


def _is_host_scalar(values) -> bool:
    return isinstance(values, (numbers.Number, np.generic)) or (
        isinstance(values, np.ndarray) and values.ndim == 0)


def _check(column: torch.Tensor, rows: torch.Tensor, values, op: str
           ) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if not isinstance(column, torch.Tensor) or column.dtype not in _FN:
        raise TypeError("column must be an int32 or float32 tensor")
    if column.dim() < 1 or not column.is_contiguous():
        raise ValueError("column must be a contiguous tensor [n, ...]")
    if column.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {column.device}")
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 \
            or rows.dim() != 1 or not rows.is_contiguous():
        raise TypeError("rows must be a contiguous 1-D int32 tensor")
    if rows.device != column.device:
        raise ValueError(f"rows on {rows.device}, column on {column.device}")
    if _is_host_scalar(values):
        return
    if not isinstance(values, torch.Tensor):
        raise TypeError(f"values must be a tensor or a host scalar, got "
                        f"{type(values)}")
    if values.dtype != column.dtype:
        raise TypeError(f"values {values.dtype} != column {column.dtype}")
    if values.device != column.device:
        raise ValueError(f"values on {values.device}, column on "
                         f"{column.device}")
    if values.dim() and tuple(values.shape) != (rows.shape[0],
                                                *column.shape[1:]):
        raise ValueError(f"values {tuple(values.shape)} do not match rows "
                         f"{tuple(rows.shape)} x column "
                         f"{tuple(column.shape)}")


def row_scatter_plain(column: torch.Tensor, rows: torch.Tensor,
                      values: Values, op: str) -> torch.Tensor:
    """Plain PyTorch version of ``row_scatter`` (same in-place contract)."""
    keep = (rows >= 0) & (rows < column.shape[0])
    idx = rows[keep].long()
    if isinstance(values, torch.Tensor):
        v = values[keep] if values.dim() else \
            values.expand(idx.shape[0], *column.shape[1:])
    else:
        v = torch.as_tensor(np.asarray(values), device=column.device).to(
            column.dtype).expand(idx.shape[0], *column.shape[1:])
    if op == "set":
        column.index_put_((idx,), v)
    elif op == "add":
        column.index_put_((idx,), v, accumulate=True)
    else:
        index = idx.reshape(-1, *([1] * (column.dim() - 1))).expand_as(v)
        column.scatter_reduce_(0, index, v, "amax", include_self=True)
    return column


def _is_scalar(values: Values) -> bool:
    """A host scalar or a 0-d tensor: one value for every lane."""
    return _is_host_scalar(values) or values.dim() == 0


def launch(column: torch.Tensor, rows: torch.Tensor, values: Values,
           op: str, plan: SegPlan) -> None:
    """Launch K3 on CUDA tensors along ``plan``.  Not counted:
    ``row_scatter`` is the path's entry; this is for probes that force a
    path."""
    m = rows.shape[0]
    if m == 0:
        return
    if _is_host_scalar(values):
        ptr, step = None, 0
        scalar = int(values) if column.dtype == torch.int32 \
            else float(values)
    else:
        if values.dim() and not values.is_contiguous():
            raise ValueError("values must be contiguous")
        # a device scalar is one element every lane reads (step 0)
        ptr, step, scalar = values.data_ptr(), int(values.dim() > 0), 0
    fn_name = _FN[column.dtype]
    lib = _build.library("scatter", _SIGNATURES, init="row_scatter_init")
    err = getattr(lib, fn_name)(
        column.data_ptr(), column.shape[0], rows.data_ptr(), m,
        column[0].numel(), ptr, step, scalar, OPS[op], plan.cluster,
        plan.chunk, plan.threads, plan.blocks_per_sm,
        torch.cuda.current_stream(column.device).cuda_stream)
    _build.check(lib, err, fn_name)


@_build.counted
def row_scatter(column: torch.Tensor, rows: torch.Tensor, values: Values,
                op: str) -> torch.Tensor:
    """Update ``column`` in place at ``rows`` with ``values`` under ``op``
    (``"set"``, ``"add"`` or ``"max"``); returns ``column``."""
    _check(column, rows, values, op)
    if column.device.type == "cpu":
        return row_scatter_plain(column, rows, values, op)
    m = rows.shape[0]
    if m == 0:
        return column
    launch(column, rows, values, op,
           scatter_plan(m, column.shape[0], column[0].numel(), op,
                        _is_scalar(values)))
    _build.note_launch(row_scatter)
    return column
