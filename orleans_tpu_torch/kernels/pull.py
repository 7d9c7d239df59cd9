"""The streams plane's pull-mode kernels.

K16 ``seg_pull``: the row-aligned segment reduction of a pull-mode
delivery.  Replaces the ``segments`` branches of
``orleans_tpu/tensor/vector_grain.py`` ``seg_sum`` and ``seg_max`` and of
``orleans_tpu/tensor/attribution.py`` ``fold_counts``.  ``values`` are
``[m]`` lanes grouped by destination row; ``offsets`` (int32
``[n_rows + 1]``, nondecreasing, ``offsets[0] == 0``, ``offsets[-1] <=
m``) give row ``r`` the lanes ``[offsets[r], offsets[r + 1])``; lanes
past ``offsets[-1]`` belong to no row.

* ``op="sum"``: the per-row sum into a new ``[n_rows]`` tensor, or added
  into ``out`` in place (the count mode of ``fold_counts``).  int32 and
  bool values sum to int32 modulo 2**32, bit-equal to JAX's int32
  cumulative-sum difference whatever the batch total; float32 values sum
  per row in lane order, within ``2**-24 * sum|x|`` of the exact sum over
  the row (JAX's prefix-sum difference carries about ``eps32 *`` the
  batch's total instead).  With ``slots`` given, the sum of every lane's
  value (all ``m``, as JAX's ``jnp.sum(inc)``) adds into
  ``slots[slot]``.
* ``op="max"``: the per-row max into a new ``[n_rows]`` tensor; a row
  with no lanes reads ``fill``.

K17 ``touch_dense``: the pull delivery's use-clock touch,
``last_use[r] = max(last_use[r], tick if offsets[r + 1] > offsets[r] else
0)`` in place.  Replaces ``orleans_tpu/tensor/arena.py``
``_touch_dense_kernel``.

The wrappers take the plain versions for CPU tensors and launch the
kernels for CUDA tensors.  What bounds each kernel on an H100 and what it
does about it is in the note at the top of ``csrc/pull.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SUM = (_P, _P, _I64, _P, ctypes.c_int, _P, _I64, _P)
_SIGNATURES = {
    "seg_pull_sum_i32": _SUM,
    "seg_pull_sum_u8": _SUM,
    "seg_pull_sum_f32": _SUM,
    "seg_pull_max_i32": (_P, _P, _I64, _I32, _P, _P),
    "seg_pull_max_f32": (_P, _P, _I64, ctypes.c_float, _P, _P),
    "touch_dense": (_P, _P, _I64, _I32, _P),
}
_SUM_FN = {torch.int32: "seg_pull_sum_i32", torch.bool: "seg_pull_sum_u8",
           torch.float32: "seg_pull_sum_f32"}
_MAX_FN = {torch.int32: "seg_pull_max_i32", torch.float32: "seg_pull_max_f32"}


def _vector(t, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 1 \
            or not t.is_contiguous():
        raise TypeError(f"{what} must be a contiguous 1-D tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _out_dtype(values: torch.Tensor) -> torch.dtype:
    """A sum's type: bool counts sum to int32, as JAX's cumsum does."""
    return torch.int32 if values.dtype == torch.bool else values.dtype


def _check(values: torch.Tensor, offsets: torch.Tensor, op: str, out,
           slots) -> None:
    _vector(values, "values")
    _vector(offsets, "offsets")
    if offsets.dtype != torch.int32 or offsets.shape[0] < 1:
        raise TypeError("offsets must be int32 [n_rows + 1]")
    if offsets.device != values.device:
        raise ValueError("values and offsets must share one device")
    if op == "sum":
        if values.dtype not in _SUM_FN:
            raise TypeError(f"a pull-mode sum takes int32, float32 or bool "
                            f"values, got {values.dtype}")
    elif op == "max":
        if values.dtype not in _MAX_FN:
            raise TypeError(f"a pull-mode max takes int32 or float32 "
                            f"values, got {values.dtype}")
        if out is not None or slots is not None:
            raise ValueError("a pull-mode max writes a new tensor and no "
                             "slot total")
    else:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    n_rows = offsets.shape[0] - 1
    if out is not None:
        _vector(out, "out")
        if out.dtype != _out_dtype(values) or out.shape[0] != n_rows \
                or out.device != values.device:
            raise ValueError(f"out must be {_out_dtype(values)} [{n_rows}] "
                             f"on {values.device}")
    if slots is not None:
        if not isinstance(slots, torch.Tensor) or slots.dtype != torch.int32 \
                or not slots.is_contiguous() \
                or slots.device != values.device:
            raise TypeError("slots must be a contiguous int32 tensor on the "
                            "values' device")
        if values.dtype == torch.float32:
            raise TypeError("a slot total counts integer lanes")


def _lane_rows(offsets: torch.Tensor) -> torch.Tensor:
    """The row of each lane in ``[0, offsets[-1])``."""
    n_rows = offsets.shape[0] - 1
    deg = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=offsets.device), deg)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2**32, read as int32 (the int32 wrap of JAX)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def seg_pull_plain(values: torch.Tensor, offsets: torch.Tensor,
                   op: str = "sum", fill=0,
                   out: Optional[torch.Tensor] = None,
                   slots: Optional[torch.Tensor] = None,
                   slot: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``seg_pull``: integer sums in int64
    wrapped to int32, float sums in float64 rounded to float32."""
    n_rows = offsets.shape[0] - 1
    rows = _lane_rows(offsets)
    lanes = values[:rows.shape[0]]
    if op == "max":
        res = torch.full((n_rows,), fill, dtype=values.dtype,
                         device=values.device)
        return res.scatter_reduce_(0, rows, lanes, "amax",
                                   include_self=False)
    wide = torch.float64 if values.dtype == torch.float32 else torch.int64
    acc = torch.zeros(n_rows, dtype=wide, device=values.device)
    if out is not None:
        acc += out.to(wide)
    acc.index_add_(0, rows, lanes.to(wide))
    res = acc.to(torch.float32) if wide == torch.float64 else _wrap32(acc)
    if slots is not None:
        flat = slots.view(-1)
        total = values.to(torch.int64).sum() + flat[slot].to(torch.int64)
        flat[slot] = _wrap32(total)
    if out is not None:
        out.copy_(res)
        return out
    return res


@_build.counted
def seg_pull(values: torch.Tensor, offsets: torch.Tensor, op: str = "sum",
             fill=0, out: Optional[torch.Tensor] = None,
             slots: Optional[torch.Tensor] = None,
             slot: int = 0) -> torch.Tensor:
    """Reduce the lanes of each row (see the module docstring)."""
    _check(values, offsets, op, out, slots)
    if values.device.type == "cpu":
        return seg_pull_plain(values, offsets, op, fill, out, slots, slot)
    n_rows = offsets.shape[0] - 1
    stream = torch.cuda.current_stream(values.device).cuda_stream
    lib = _build.library("pull", _SIGNATURES)
    if op == "max":
        res = torch.empty(n_rows, dtype=values.dtype, device=values.device)
        fn_name = _MAX_FN[values.dtype]
        fill_c = float(fill) if values.dtype == torch.float32 else int(fill)
        err = getattr(lib, fn_name)(values.data_ptr(), offsets.data_ptr(),
                                    n_rows, fill_c, res.data_ptr(), stream)
    else:
        res = out if out is not None else torch.empty(
            n_rows, dtype=_out_dtype(values), device=values.device)
        total = 0 if slots is None \
            else slots.data_ptr() + 4 * int(slot)
        fn_name = _SUM_FN[values.dtype]
        err = getattr(lib, fn_name)(values.data_ptr(), offsets.data_ptr(),
                                    n_rows, res.data_ptr(),
                                    int(out is not None), total or None,
                                    values.shape[0], stream)
    _build.check(lib, err, fn_name)
    _build.note_launch(seg_pull)
    return res


def _check_touch(last_use: torch.Tensor, offsets: torch.Tensor,
                 tick: int) -> None:
    _vector(last_use, "last_use")
    _vector(offsets, "offsets")
    if last_use.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("last_use and offsets must be int32")
    if offsets.shape[0] != last_use.shape[0] + 1 \
            or offsets.device != last_use.device:
        raise ValueError("offsets must be [n_rows + 1] for last_use "
                         "[n_rows], on its device")
    if not -2**31 <= int(tick) < 2**31:
        raise OverflowError(f"tick {tick} outside int32")


def touch_dense_plain(last_use: torch.Tensor, offsets: torch.Tensor,
                      tick: int) -> None:
    """Plain PyTorch version of ``touch_dense``."""
    live = offsets[1:] > offsets[:-1]
    stamp = torch.where(live, int(tick), 0).to(torch.int32)
    torch.maximum(last_use, stamp, out=last_use)


@_build.counted
def touch_dense(last_use: torch.Tensor, offsets: torch.Tensor,
                tick: int) -> None:
    """Stamp ``tick`` on every row with lanes, in place."""
    _check_touch(last_use, offsets, tick)
    if last_use.device.type == "cpu":
        touch_dense_plain(last_use, offsets, tick)
        return
    lib = _build.library("pull", _SIGNATURES)
    err = lib.touch_dense(last_use.data_ptr(), offsets.data_ptr(),
                          last_use.shape[0], int(tick),
                          torch.cuda.current_stream(
                              last_use.device).cuda_stream)
    _build.check(lib, err, "touch_dense")
    _build.note_launch(touch_dense)
