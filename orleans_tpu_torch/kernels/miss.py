"""K6 ``miss_keys``: the unseen keys of a batch that missed, for the
engine's miss-check drain to activate.

Replaces ``orleans_tpu/tensor/engine.py`` ``_miss_keys_kernel``.  A lane
is missing when its row is ``< 0``, it is valid and its key is below the
sentinel.  Returns the sorted unique keys of the missing lanes — the
smallest ``miss_buf`` of them when there are more — padded with
``KEY_SENTINEL`` to ``miss_buf``, and the ``missing`` lane mask: exactly
``jnp.unique(where(missing, keys, SENTINEL), size=miss_buf,
fill_value=SENTINEL)``.  The kernel chain runs on the stream with no host
synchronisation; the drain's one device-to-host copy of the keys follows
it.  One wrapper call is one counted launch of the chain.

What bounds it on an H100 and its design are in the note at the top of
``csrc/miss.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {"miss_keys": (_P, _P, _P, _I64, _P, _P, _I64, _P, _I64, _P,
                             _I64, _P, _P)}


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _check(keys: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
           miss_buf: int) -> None:
    for name, t, dtype in (("keys", keys, torch.int32),
                           ("rows", rows, torch.int32),
                           ("valid", valid, torch.bool)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D {dtype} "
                            f"tensor")
        if t.shape != keys.shape or t.device != keys.device:
            raise ValueError(f"{name} must match keys in shape and device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if miss_buf < 1:
        raise ValueError(f"miss_buf must be >= 1, got {miss_buf}")


def miss_keys_plain(keys: torch.Tensor, rows: torch.Tensor,
                    valid: torch.Tensor, miss_buf: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``miss_keys``."""
    missing = (rows < 0) & valid & (keys < KEY_SENTINEL)
    uniq = torch.unique(torch.where(missing, keys, KEY_SENTINEL),
                        sorted=True)
    out = torch.full((miss_buf,), KEY_SENTINEL, dtype=keys.dtype,
                     device=keys.device)
    n = min(uniq.shape[0], miss_buf)
    out[:n] = uniq[:n]
    return out, missing


@_build.counted
def miss_keys(keys: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
              miss_buf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted unique unseen keys padded to ``miss_buf``, missing mask)."""
    _check(keys, rows, valid, miss_buf)
    if keys.device.type == "cpu":
        return miss_keys_plain(keys, rows, valid, miss_buf)
    m = keys.shape[0]
    dev = keys.device
    out = torch.empty(miss_buf, dtype=torch.int32, device=dev)
    missing = torch.empty(m, dtype=torch.bool, device=dev)
    if m == 0:
        out.fill_(KEY_SENTINEL)
        return out, missing
    p = max(64, _pow2_at_least(2 * m))      # hash table: load <= 1/2
    c = max(2, _pow2_at_least(m))           # compact buffer, sorted whole
    table = torch.empty(p, dtype=torch.int32, device=dev)
    compact = torch.empty(c, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _build.library("miss", _SIGNATURES)
    err = lib.miss_keys(
        keys.data_ptr(), rows.data_ptr(), valid.data_ptr(), m,
        missing.data_ptr(), out.data_ptr(), miss_buf, table.data_ptr(), p,
        compact.data_ptr(), c, counter.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "miss_keys")
    _build.note_launch(miss_keys)
    return out, missing
