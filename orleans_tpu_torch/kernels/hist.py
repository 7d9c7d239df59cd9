"""K5 ``hist_count``: ``hist[slot, bucket] += count(base & (rows >= 0))``
in place, the latency ledger's one-cell masked count.

Replaces ``orleans_tpu/tensor/ledger.py`` ``_count_rows_kernel`` (the
unfused tick's device-routed batches) and the fused window's in-window
ledger add, ``orleans_tpu/tensor/fused.py`` ``hist.at[slot, 0].add(
sum(mask))``: with ``rows=None`` the count is of the mask alone.  The
fused window also counts its delivered and spilled lanes into its
``[1, 2]`` totals with it.  Integer counts: the kernel and its plain
version agree exactly.

What bounds the kernel on an H100 and what it does about it is in the
note at the top of ``csrc/hist.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orleans_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_SIGNATURES = {"hist_count": (_P, ctypes.c_int64, _P, _P, ctypes.c_int64,
                              _P)}


def _check(hist: torch.Tensor, slot: int, bucket: int, base: torch.Tensor,
           rows: Optional[torch.Tensor]) -> None:
    if not isinstance(hist, torch.Tensor) or hist.dtype != torch.int32 \
            or hist.dim() != 2 or not hist.is_contiguous():
        raise TypeError("hist must be a contiguous 2-D int32 tensor")
    if hist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hist.device}")
    if not (0 <= slot < hist.shape[0] and 0 <= bucket < hist.shape[1]):
        raise IndexError(f"cell ({slot}, {bucket}) outside hist "
                         f"{tuple(hist.shape)}")
    if not isinstance(base, torch.Tensor) or base.dtype != torch.bool \
            or base.dim() != 1 or not base.is_contiguous():
        raise TypeError("base must be a contiguous 1-D bool tensor")
    if base.device != hist.device:
        raise ValueError(f"base on {base.device}, hist on {hist.device}")
    if rows is not None:
        if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 \
                or rows.dim() != 1 or not rows.is_contiguous():
            raise TypeError("rows must be a contiguous 1-D int32 tensor")
        if rows.shape != base.shape or rows.device != base.device:
            raise ValueError("rows and base must share shape and device")


def hist_count_plain(hist: torch.Tensor, slot: int, bucket: int,
                     base: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``hist_count`` (same in-place contract)."""
    valid = base if rows is None else base & (rows >= 0)
    hist[slot, bucket] += valid.sum(dtype=torch.int32)
    return hist


@_build.counted
def hist_count(hist: torch.Tensor, slot: int, bucket: int,
               base: torch.Tensor,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the count of lanes with ``base`` set (and ``rows >= 0`` when
    rows are given) into ``hist[slot, bucket]``; returns ``hist``."""
    _check(hist, slot, bucket, base, rows)
    if hist.device.type == "cpu":
        return hist_count_plain(hist, slot, bucket, base, rows)
    m = base.shape[0]
    if m == 0:
        return hist
    lib = _build.library("hist", _SIGNATURES)
    err = lib.hist_count(
        hist.data_ptr(), slot * hist.shape[1] + bucket, base.data_ptr(),
        None if rows is None else rows.data_ptr(), m,
        torch.cuda.current_stream(hist.device).cuda_stream)
    _build.check(lib, err, "hist_count")
    _build.note_launch(hist_count)
    return hist
