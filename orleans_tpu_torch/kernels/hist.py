"""K5 ``hist_count``: ``hist[slot, bucket] += count(base & (rows >= 0))``
in place, the latency ledger's one-cell masked count.

Replaces ``orleans_tpu/tensor/ledger.py`` ``_count_rows_kernel`` (the
unfused tick's device-routed batches) and the fused window's in-window
ledger add, ``orleans_tpu/tensor/fused.py`` ``hist.at[slot, 0].add(
sum(mask))``: with ``rows=None`` the count is of the mask alone.  The
fused window also counts its delivered and spilled lanes into its
``[1, 2]`` totals with it.

``hist_count_many`` is the same kernel over a table of up to
``MAX_ENTRIES`` counts in one launch (its blocks split over the entries by
their lanes, from shapes alone): a fused window gathers a tick's counts
and launches them once at the tick's end.  Integer counts: the kernel and
its plain version agree exactly, in any order.

What bounds the kernel on an H100 and what it does about it is in the
note at the top of ``csrc/hist.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from orleans_tpu_torch.kernels import _build

#: counts one ``hist_count_many`` launch takes (``kMaxEntries`` in
#: ``csrc/hist.cu``); a longer list launches once per this many
MAX_ENTRIES = 8
#: threads a block (``kThreads``); each thread takes 16-lane groups
COUNT_THREADS = 256
GROUP = 16

_P = ctypes.c_void_p
_SIGNATURES = {"hist_count_wave": (),
               "hist_count_many": (ctypes.c_int32, _P, _P, _P, _P, _P, _P)}
# device index -> blocks one wave of that card holds
_WAVE: Dict[int, int] = {}

#: one count: (hist, slot, bucket, base, rows or None)
Count = Tuple[torch.Tensor, int, int, torch.Tensor, Optional[torch.Tensor]]


def count_plan(ms: Sequence[int], wave: int) -> List[int]:
    """Blocks of each count of one launch, from its lanes alone: a thread
    a 16-lane group, so ceil(m / 16 / 256) blocks; when the launch wants
    more than one ``wave`` of the card, each count keeps its share of the
    wave (at least one block); a count of no lanes gets none."""
    groups = [-(-m // GROUP) for m in ms]
    want = [-(-g // COUNT_THREADS) for g in groups]
    total = sum(want)
    if total > wave:
        want = [0 if w == 0 else max(1, w * wave // total) for w in want]
    return want


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
    hist_count_many([(hist, slot, bucket, base, rows)])
    return hist


def _launch(part: Sequence[Count]) -> None:
    """One launch of the kernel over ``part`` (1 to ``MAX_ENTRIES`` counts
    on one card, at least one of them with lanes)."""
    dev = part[0][0].device
    lib = _build.library("hist", _SIGNATURES)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if index not in _WAVE:
        with torch.cuda.device(index):
            _WAVE[index] = int(lib.hist_count_wave())
    n = len(part)
    blocks = count_plan([e[3].shape[0] for e in part], _WAVE[index])
    cells = (ctypes.c_int64 * n)(*[
        h.data_ptr() + h.element_size() * (slot * h.shape[1] + bucket)
        for h, slot, bucket, _b, _r in part])
    bases = (ctypes.c_int64 * n)(*[e[3].data_ptr() for e in part])
    rows = (ctypes.c_int64 * n)(*[0 if e[4] is None else e[4].data_ptr()
                                  for e in part])
    ms = (ctypes.c_int64 * n)(*[e[3].shape[0] for e in part])
    err = lib.hist_count_many(n, cells, bases, rows, ms,
                              (ctypes.c_int32 * n)(*blocks),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "hist_count_many")


def hist_count_many_plain(entries: Sequence[Count]) -> None:
    """Plain PyTorch version of ``hist_count_many``: each count in turn."""
    for h, slot, bucket, base, rows in entries:
        hist_count_plain(h, slot, bucket, base, rows)


def hist_count_many(entries: Sequence[Count]) -> None:
    """Every count of ``entries`` — ``(hist, slot, bucket, base, rows)``,
    each as ``hist_count`` takes it — in one launch a ``MAX_ENTRIES``;
    all on one device.  Entries of no lanes count nothing.  Its launches
    count as ``hist_count``'s (one kernel, one counter)."""
    entries = list(entries)
    for e in entries:
        _check(*e)
    if not entries:
        return
    dev = entries[0][0].device
    if any(e[0].device != dev for e in entries):
        raise ValueError("hist_count_many: entries on several devices")
    if dev.type == "cpu":
        hist_count_many_plain(entries)
        return
    for at in range(0, len(entries), MAX_ENTRIES):
        part = entries[at:at + MAX_ENTRIES]
        if any(e[3].shape[0] for e in part):
            _launch(part)
            _build.note_launch(hist_count)
