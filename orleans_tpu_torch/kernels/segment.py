"""K4 ``seg_sum``: the scatter-path segment sum of a tick's fan-in.

Replaces the scatter path of ``orleans_tpu/tensor/vector_grain.py``
``seg_sum`` (``jax.ops.segment_sum`` over rows with padding dropped):
``out[r] = sum(values[i] for i with rows[i] == r)`` into a fresh
zero-initialised ``[n_rows, ...]`` tensor; lanes whose row is ``< 0`` or
``>= n_rows`` are dropped.  int32 sums are exact; float32 sums on the card
come out in atomic order, which changes from run to run (compare within
Higham's bound for recursive summation, ``(k - 1) * 2**-24 * sum|x|``).

What bounds the kernel on an H100 and what it does about it is in the
note at the top of ``csrc/segment.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "seg_sum_i32": (_P, _P, _I64, _I64, _P, _I64, _P),
    "seg_sum_f32": (_P, _P, _I64, _I64, _P, _I64, _P),
}
_FN = {torch.int32: "seg_sum_i32", torch.float32: "seg_sum_f32"}


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
    fn_name = _FN[values.dtype]
    lib = _build.library("segment", _SIGNATURES)
    err = getattr(lib, fn_name)(
        values.data_ptr(), rows.data_ptr(), m, values[0].numel(),
        out.data_ptr(), n_rows,
        torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(lib, err, fn_name)
    _build.note_launch(seg_sum)
    return out
