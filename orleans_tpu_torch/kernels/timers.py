"""The device timers plane's kernels, over int32 slot columns ``key``,
``due``, ``name`` and ``period`` (slot 0 is the dead slot pads target).

K14 ``timers_write``: the batched arm/cancel write of all four columns
at ``idx`` in place, dropping slots outside ``[0, n)`` (replaces
``orleans_tpu/tensor/timers_plane.py`` ``_write_kernel``).

K15 ``timers_harvest``: the per-tick pass over a due bucket's slots —
gather, fire predicate, phase-preserving periodic re-arm and one-shot
free written back in place — returning the gathered keys, names and the
fired mask of every lane, pads included (replaces ``_harvest_kernel``).
The arithmetic is JAX's int32 arithmetic: additions, subtractions and
products wrap, and the division floors.

Both are exact: the kernels and their plain versions agree bit for bit.
What bounds each kernel on an H100 and what it does about it is in the
note at the top of ``csrc/timers.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from orleans_tpu_torch.kernels import _build

#: the dead-slot / freed-slot key (int32 max, the device key sentinel)
SENTINEL = 2**31 - 1

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "timers_write": (_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _P),
    "timers_harvest": (_P, _P, _P, _P, _I64, _P, _I64, ctypes.c_int32, _P,
                       _P, _P, _P),
}


def _vectors(ts: Sequence[torch.Tensor], names: str, length: int,
             device: torch.device) -> None:
    for t, what in zip(ts, names.split()):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{what} must be a contiguous 1-D int32 tensor")
        if t.shape[0] != length:
            raise ValueError(f"{what} has {t.shape[0]} lanes, expected "
                             f"{length}")
        if t.device != device:
            raise ValueError(f"{what} on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (JAX's int32 overflow)."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def timers_write_plain(key, due, name, period, idx, k, d, nm, p) -> None:
    """Plain PyTorch version of ``timers_write`` (same in-place
    contract)."""
    keep = (idx >= 0) & (idx < key.shape[0])
    s = idx[keep].long()
    for col, v in ((key, k), (due, d), (name, nm), (period, p)):
        col.index_put_((s,), v[keep])


@_build.counted
def timers_write(key: torch.Tensor, due: torch.Tensor, name: torch.Tensor,
                 period: torch.Tensor, idx: torch.Tensor, k: torch.Tensor,
                 d: torch.Tensor, nm: torch.Tensor, p: torch.Tensor) -> None:
    """Write ``(k, d, nm, p)`` into ``(key, due, name, period)`` at the
    slots ``idx`` in place; slots outside ``[0, n)`` are dropped."""
    n = key.shape[0] if isinstance(key, torch.Tensor) else 0
    _vectors((key, due, name, period), "key due name period", n, key.device)
    w = idx.shape[0] if isinstance(idx, torch.Tensor) else 0
    _vectors((idx, k, d, nm, p), "idx k d nm p", w, key.device)
    if key.device.type == "cpu":
        return timers_write_plain(key, due, name, period, idx, k, d, nm, p)
    if w == 0:
        return
    lib = _build.library("timers", _SIGNATURES)
    err = lib.timers_write(
        key.data_ptr(), due.data_ptr(), name.data_ptr(), period.data_ptr(),
        n, idx.data_ptr(), k.data_ptr(), d.data_ptr(), nm.data_ptr(),
        p.data_ptr(), w, torch.cuda.current_stream(key.device).cuda_stream)
    _build.check(lib, err, "timers_write")
    _build.note_launch(timers_write)


def timers_harvest_plain(key, due, period, name, idx, now: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain PyTorch version of ``timers_harvest`` (same in-place
    contract); int32 wrap and floor division as JAX computes them."""
    n = key.shape[0]
    g = idx.clamp(0, n - 1).long()
    k, d, p, nm = key[g], due[g], period[g], name[g]
    fired = (k != SENTINEL) & (d <= now)
    rearm = fired & (p > 0)
    diff = _wrap32(now - d.long()).long()
    steps = _wrap32(torch.div(diff, p.clamp(min=1).long(),
                              rounding_mode="floor") + 1).long()
    d2 = torch.where(rearm, _wrap32(d.long() + _wrap32(steps * p.long())), d)
    k2 = torch.where(fired & ~rearm, torch.full_like(k, SENTINEL), k)
    keep = (idx >= 0) & (idx < n)
    s = idx[keep].long()
    key.index_put_((s,), k2[keep])
    due.index_put_((s,), d2[keep])
    return k, nm, fired


@_build.counted
def timers_harvest(key: torch.Tensor, due: torch.Tensor,
                   period: torch.Tensor, name: torch.Tensor,
                   idx: torch.Tensor, now: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harvest the slots ``idx`` at tick ``now``: re-arm fired periodic
    timers and free fired one-shots in ``key``/``due`` in place; returns
    the gathered keys, names and the fired mask, one per lane."""
    n = key.shape[0] if isinstance(key, torch.Tensor) else 0
    _vectors((key, due, period, name), "key due period name", n, key.device)
    w = idx.shape[0] if isinstance(idx, torch.Tensor) else 0
    _vectors((idx,), "idx", w, key.device)
    if n == 0:
        raise ValueError("timers_harvest: the slot columns are empty")
    if not -2**31 <= int(now) < 2**31:
        raise OverflowError(f"now {now} outside int32")
    if key.device.type == "cpu":
        return timers_harvest_plain(key, due, period, name, idx, int(now))
    dev = key.device
    k_out = torch.empty(w, dtype=torch.int32, device=dev)
    nm_out = torch.empty(w, dtype=torch.int32, device=dev)
    fired = torch.empty(w, dtype=torch.bool, device=dev)
    if w == 0:
        return k_out, nm_out, fired
    lib = _build.library("timers", _SIGNATURES)
    err = lib.timers_harvest(
        key.data_ptr(), due.data_ptr(), period.data_ptr(), name.data_ptr(),
        n, idx.data_ptr(), w, int(now), k_out.data_ptr(), nm_out.data_ptr(),
        fired.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "timers_harvest")
    _build.note_launch(timers_harvest)
    return k_out, nm_out, fired
