"""K1 ``resolve_dense`` and K2 ``resolve_sorted``: key → row resolution of
emitted messages on the device, with the count of misses.

``resolve_dense`` replaces ``orleans_tpu/tensor/engine.py``
``_resolve_rows_dense_kernel`` (one gather from a dense direct map);
``resolve_sorted`` replaces ``_resolve_rows_kernel`` (a lower-bound binary
search over the sentinel-padded sorted key mirror).  Both return ``rows``
(int32, -1 where the key is padding, invalid or not active) and the miss
count (an int32 scalar tensor: lanes that were valid but did not resolve),
which stays on the device until the engine's miss-check drain reads it.
Given ``misses`` (a one-element int32 tensor on the keys' device), the
count adds into it instead of a fresh zeroed scalar: a fused window sums
every tick's misses into its one device total that way.

What bounds them on an H100 and what the kernels do about it is in the
note at the top of ``csrc/resolve.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orleans_tpu_torch.kernels import _build

# Device-path key sentinel: resolve kernels treat any key >= this as
# padding and drop it.  Single definition (re-exported by vector_grain).
KEY_SENTINEL = 2**31 - 1

_P = ctypes.c_void_p
_SIGNATURES = {
    "resolve_dense": (_P, ctypes.c_int32, _P, _P, _P, _P, ctypes.c_int64,
                      _P),
    "resolve_sorted": (_P, _P, ctypes.c_int32, _P, _P, _P, _P,
                       ctypes.c_int64, _P),
}


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


def _miss_counter(misses, keys: torch.Tensor) -> torch.Tensor:
    """A fresh zeroed int32 scalar, or the caller's accumulator."""
    if misses is None:
        return torch.zeros((), dtype=torch.int32, device=keys.device)
    if not isinstance(misses, torch.Tensor) or misses.dtype != torch.int32 \
            or misses.numel() != 1 or misses.device != keys.device:
        raise TypeError("misses must be a one-element int32 tensor on the "
                        "keys' device")
    return misses


def _launch(fn_name: str, rows: torch.Tensor, *args) -> None:
    lib = _build.library("resolve", _SIGNATURES)
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
                misses.data_ptr(), m)
        _build.note_launch(resolve_dense)
    return rows, misses


# -- K2 ----------------------------------------------------------------------

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
        _launch("resolve_sorted", rows, sorted_keys.data_ptr(),
                sorted_rows.data_ptr(), sorted_keys.shape[0],
                keys.data_ptr(), valid.data_ptr(), rows.data_ptr(),
                misses.data_ptr(), m)
        _build.note_launch(resolve_sorted)
    return rows, misses
