"""The grain lifecycle's kernels.

K12 ``idle_mask``: ``live & (max(last_use_dev, host_clock) < cutoff)``,
the collection sweep's victim mask (replaces
``orleans_tpu/tensor/arena.py`` ``_idle_mask_kernel``).

K13 ``gather_rows``: ``column[clip(rows, 0, n - 1)]`` for a column of
4-byte elements with any trailing width (replaces
``orleans_tpu/tensor/attribution.py`` ``_gather_counts``, and serves the
eager gathers of the JAX arena's ``rows_to_host`` and
``deactivate_idle_rows``).  Pad lanes read row 0; the caller slices them
off.

Both are exact: the kernels and their plain versions agree bit for bit.
What bounds each kernel on an H100 and what it does about it is in the
note at the top of ``csrc/lifecycle.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "idle_mask": (_P, _P, _P, ctypes.c_int32, _P, _I64, _P),
    "gather_rows": (_P, _I64, _P, _I64, _I64, _P, _P),
}


def _vector(t, dtype: torch.dtype, what: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype \
            or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{what} must be a contiguous 1-D {dtype} tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_idle(last_use_dev: torch.Tensor, host_clock: torch.Tensor,
                live: torch.Tensor, cutoff: int) -> None:
    _vector(last_use_dev, torch.int32, "last_use_dev")
    _vector(host_clock, torch.int32, "host_clock")
    _vector(live, torch.bool, "live")
    if host_clock.shape != last_use_dev.shape \
            or live.shape != last_use_dev.shape:
        raise ValueError("last_use_dev, host_clock and live must share "
                         "one shape")
    if host_clock.device != last_use_dev.device \
            or live.device != last_use_dev.device:
        raise ValueError("last_use_dev, host_clock and live must share "
                         "one device")
    if not -2**31 < int(cutoff) < 2**31:
        raise OverflowError(f"cutoff {cutoff} outside the clipped int32 "
                            f"range")


def idle_mask_plain(last_use_dev: torch.Tensor, host_clock: torch.Tensor,
                    live: torch.Tensor, cutoff: int) -> torch.Tensor:
    """Plain PyTorch version of ``idle_mask``."""
    return live & (torch.maximum(last_use_dev, host_clock) < int(cutoff))


@_build.counted
def idle_mask(last_use_dev: torch.Tensor, host_clock: torch.Tensor,
              live: torch.Tensor, cutoff: int) -> torch.Tensor:
    """The bool victim mask of rows live and idle since before
    ``cutoff`` by both use clocks (the host clips its clock to
    ``[0, 2**31 - 1]`` and the cutoff to ``[-2**31 + 1, 2**31 - 1]``)."""
    _check_idle(last_use_dev, host_clock, live, cutoff)
    if last_use_dev.device.type == "cpu":
        return idle_mask_plain(last_use_dev, host_clock, live, cutoff)
    n = last_use_dev.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=last_use_dev.device)
    if n == 0:
        return out
    lib = _build.library("lifecycle", _SIGNATURES)
    err = lib.idle_mask(
        last_use_dev.data_ptr(), host_clock.data_ptr(), live.data_ptr(),
        int(cutoff), out.data_ptr(), n,
        torch.cuda.current_stream(last_use_dev.device).cuda_stream)
    _build.check(lib, err, "idle_mask")
    _build.note_launch(idle_mask)
    return out


def _check_gather(column: torch.Tensor, rows: torch.Tensor) -> None:
    if not isinstance(column, torch.Tensor) or column.element_size() != 4 \
            or column.dim() < 1 or not column.is_contiguous():
        raise TypeError("column must be a contiguous tensor [n, ...] of a "
                        "4-byte dtype")
    if column.shape[0] == 0:
        raise ValueError("column has no rows to gather from")
    _vector(rows, torch.int32, "rows")
    if rows.device != column.device:
        raise ValueError(f"rows on {rows.device}, column on "
                         f"{column.device}")


def gather_rows_plain(column: torch.Tensor, rows: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``gather_rows``."""
    return column.index_select(
        0, rows.clamp(0, column.shape[0] - 1).long())


@_build.counted
def gather_rows(column: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``column[clip(rows, 0, n - 1)]`` as a new ``[m, *width]`` tensor."""
    _check_gather(column, rows)
    if column.device.type == "cpu":
        return gather_rows_plain(column, rows)
    m = rows.shape[0]
    out = torch.empty((m, *column.shape[1:]), dtype=column.dtype,
                      device=column.device)
    if m == 0 or out.numel() == 0:
        return out
    lib = _build.library("lifecycle", _SIGNATURES)
    err = lib.gather_rows(
        column.data_ptr(), column.shape[0], rows.data_ptr(), m,
        column[0].numel(), out.data_ptr(),
        torch.cuda.current_stream(column.device).cuda_stream)
    _build.check(lib, err, "gather_rows")
    _build.note_launch(gather_rows)
    return out
