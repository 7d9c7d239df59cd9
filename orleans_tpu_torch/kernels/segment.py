"""K4 ``seg_sum``: the scatter-path segment sum of a tick's fan-in.

Replaces the scatter path of ``orleans_tpu/tensor/vector_grain.py``
``seg_sum`` (``jax.ops.segment_sum`` over rows with padding dropped):
``out[r] = sum(values[i] for i with rows[i] == r)`` into a fresh
zero-initialised ``[n_rows, ...]`` tensor; lanes whose row is ``< 0`` or
``>= n_rows`` are dropped.  int32 sums are exact; float32 sums on the card
come out in atomic order, which changes from run to run (compare within
Higham's bound for recursive summation, ``(k - 1) * 2**-24 * sum|x|``).

``seg_plan`` picks the kernel's path from shapes alone (a CUDA graph bakes
the launch): direct global atomics, or a copy of the output privatized in
each block's shared memory and summed over a thread-block cluster.  What
bounds the kernel on an H100 and what it does about it is in the note at
the top of ``csrc/segment.cu``.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "seg_sum_i32": (_P, _P, _I64, _I64, _P, _I64, _INT, _I64, _INT, _INT,
                    _P),
    "seg_sum_f32": (_P, _P, _I64, _I64, _P, _I64, _INT, _I64, _INT, _INT,
                    _P),
    "seg_sum_init": (),
}
_FN = {torch.int32: "seg_sum_i32", torch.float32: "seg_sum_f32"}

#: elements per output word from which the output is privatized
SEG_MIN_PER_WORD = 8
#: output bytes a privatized block holds at most (its whole copy)
SEG_BLOCK_BYTES = 128 * 1024
#: blocks of a thread-block cluster that sum their copies together (1:
#: every block flushes its own copy)
SEG_CLUSTER = 8
#: threads a block and blocks on each SM: direct, privatized (a copy above
#: half of an SM's shared memory leaves one block an SM)
SEG_DIRECT = (256, 32)
SEG_PRIVATE = (512, 2)


class SegPlan(NamedTuple):
    """K4's path for one call's shapes.  ``cluster`` 0: direct global
    atomics.  Otherwise every block holds a copy of ``cluster * chunk``
    output words, and block ``r`` of a cluster of ``cluster`` blocks sums
    words ``[r * chunk, (r + 1) * chunk)`` of the cluster's copies into the
    output.  ``threads`` a block, at most ``blocks_per_sm`` blocks on each
    SM."""
    cluster: int
    chunk: int
    threads: int
    blocks_per_sm: int

    def block_words(self, words: int) -> List[Tuple[int, int]]:
        """The output words ``[lo, hi)`` each block of a cluster flushes."""
        return [(min(r * self.chunk, words), min((r + 1) * self.chunk, words))
                for r in range(self.cluster)]


def seg_plan(m: int, n_rows: int, inner: int = 1,
             dtype: torch.dtype = torch.int32) -> SegPlan:
    """K4's path from shapes alone: ``m`` lanes of ``inner`` elements into
    ``n_rows`` rows.  The output is privatized when at least
    ``SEG_MIN_PER_WORD`` elements may hit each of its words and it fits
    ``SEG_BLOCK_BYTES`` of a block's shared memory; else direct."""
    words = n_rows * inner
    if words == 0 or m * inner < SEG_MIN_PER_WORD * words \
            or words * dtype.itemsize > SEG_BLOCK_BYTES:
        return SegPlan(0, 0, *SEG_DIRECT)
    chunk = -(-words // SEG_CLUSTER)
    return SegPlan(SEG_CLUSTER, -(-chunk // 4) * 4, *SEG_PRIVATE)


def _check(values: torch.Tensor, rows: torch.Tensor, n_rows: int) -> None:
    if not isinstance(values, torch.Tensor) or values.dtype not in _FN:
        raise TypeError("values must be an int32 or float32 tensor")
    if values.dim() < 1 or not values.is_contiguous():
        raise ValueError("values must be a contiguous tensor [m, ...]")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {values.device}")
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 \
            or rows.dim() != 1 or not rows.is_contiguous():
        raise TypeError("rows must be a contiguous 1-D int32 tensor")
    if rows.device != values.device or rows.shape[0] != values.shape[0]:
        raise ValueError("rows and values must share device and length")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def seg_sum_plain(values: torch.Tensor, rows: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``seg_sum``."""
    out = torch.zeros((n_rows, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    keep = (rows >= 0) & (rows < n_rows)
    return out.index_add_(0, rows[keep].long(), values[keep])


def launch(values: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
           plan: SegPlan) -> None:
    """Launch K4 on CUDA tensors: add the lanes into ``out`` ([n_rows,
    ...], zeroed by the caller, any address) along ``plan``.  Not
    counted: ``seg_sum`` is the path's entry; this is for probes that
    place the output themselves."""
    m, n_rows = rows.shape[0], out.shape[0]
    if m == 0 or n_rows == 0:
        return
    fn_name = _FN[values.dtype]
    lib = _build.library("segment", _SIGNATURES, init="seg_sum_init")
    err = getattr(lib, fn_name)(
        values.data_ptr(), rows.data_ptr(), m, values[0].numel(),
        out.data_ptr(), n_rows, plan.cluster, plan.chunk, plan.threads,
        plan.blocks_per_sm,
        torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(lib, err, fn_name)


@_build.counted
def seg_sum(values: torch.Tensor, rows: torch.Tensor,
            n_rows: int) -> torch.Tensor:
    """Sum ``values`` per destination row into ``[n_rows, ...]``."""
    _check(values, rows, n_rows)
    if values.device.type == "cpu":
        return seg_sum_plain(values, rows, n_rows)
    out = torch.zeros((n_rows, *values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    m = rows.shape[0]
    if m == 0 or n_rows == 0:
        return out
    launch(values, rows, out,
           seg_plan(m, n_rows, values[0].numel(), values.dtype))
    _build.note_launch(seg_sum)
    return out
