"""K6 ``miss_keys``: the unseen keys of a batch that missed, for the
engine's miss-check drain to activate (and, in a cluster, to ship to the
silo that owns them).

Replaces ``orleans_tpu/tensor/engine.py`` ``_miss_keys_kernel``.  A lane
is missing when its row is ``< 0``, it is valid and its key is below the
sentinel.  Returns the sorted unique keys of the missing lanes — the
smallest ``miss_buf`` of them when there are more — padded with
``KEY_SENTINEL`` to ``miss_buf``, and the ``missing`` lane mask: exactly
``jnp.unique(where(missing, keys, SENTINEL), size=miss_buf,
fill_value=SENTINEL)``.  The kernel chain runs on the stream with no host
synchronisation; the drain's one device-to-host copy of the keys follows
it.  One wrapper call is one counted launch of the chain.

The hash table and its count are a pool per (device, stream)
(``_build.stream_pool``), filled once when made and left so by every
launch (it clears only the slots it
used), so no call fills the table.  What bounds the chain on an H100 and
its design are in the note at the top of ``csrc/miss.cu``.
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
                             _P, _P, _P, _P, _I64, _P)}
#: the sort's cooperative grid is capped at this many blocks (its digit
#: counts take 256 int32 a block)
MAX_SORT_BLOCKS = 1024

def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _fresh_pool(device: torch.device, p: int) -> list:
    """The table of ``p`` slots, all the sentinel, and the count and the
    emit's done-counter, both 0: every launch leaves them so, clearing only
    the slots it used."""
    return [torch.full((p,), KEY_SENTINEL, dtype=torch.int32,
                       device=device),
            torch.zeros(2, dtype=torch.int32, device=device)]


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
    table, state = _build.stream_pool(
        "miss_keys", dev, lambda p: _fresh_pool(dev, p),
        max(1024, _pow2_at_least(2 * m)))
    uniq, slots, spare = (torch.empty(m, dtype=torch.int32, device=dev)
                          for _ in range(3))
    block_counts = torch.empty(256 * MAX_SORT_BLOCKS, dtype=torch.int32,
                               device=dev)
    lib = _build.library("miss", _SIGNATURES, init="miss_keys_init")
    err = lib.miss_keys(
        keys.data_ptr(), rows.data_ptr(), valid.data_ptr(), m,
        missing.data_ptr(), out.data_ptr(), miss_buf, table.data_ptr(),
        table.shape[0], state.data_ptr(), uniq.data_ptr(), slots.data_ptr(),
        spare.data_ptr(), block_counts.data_ptr(), MAX_SORT_BLOCKS,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _build.drop_pool("miss_keys", dev)
    _build.check(lib, err, "miss_keys")
    _build.note_launch(miss_keys)
    return out, missing
