"""K11 ``fanout_expand``: ragged expansion of published messages through a
CSR subscription graph, on the device.

Replaces ``orleans_tpu/tensor/fanout.py`` ``_expand_kernel``.  Given the
graph as ``csr_keys`` (sorted source keys), ``csr_offsets`` (their edge
ranges) and ``csr_dst`` (the destination key of every edge; its length is
the expansion width W), and ``m`` source messages ``src_keys`` with a
``valid`` mask, it returns

* ``dst`` int32[W]: the destination key of each output slot, the key
  sentinel where the slot is invalid;
* ``src_index`` int32[W]: the source lane each slot's payload comes from;
* ``out_valid`` bool[W];
* ``total``: the int32 number of slots the messages need (0-d tensor);
* ``src_dropped`` bool[m]: source lanes with edges whose slot range ends
  past W — they deliver nothing this round (all or nothing per lane);
* ``n_dropped``: their count, as a one-element int32 tensor, added into
  the caller's counter when one is given (a fused window's miss total).

The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors.  ``m == 0`` returns the empty expansion (every
slot invalid), where the JAX kernel fails to trace.  The lane pass's
look-back words are a zeroed pool per (device, stream) that every launch
leaves zeroed (``_build.stream_pool``; inside a CUDA graph's capture,
fresh ones zeroed in the graph).  What bounds the kernel on an H100 and what its design does about
it is in the note at the top of ``csrc/fanout.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.resolve import (
    KEY_SENTINEL,
    _check_vector,
    _miss_counter,
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SIGNATURES = {"fanout_expand": (_P, _P, _I32, _P, _I32, _P, _P, _I64, _P,
                                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)}
#: lanes a tile of the lane pass, slots a tile of the slot pass
#: (``csrc/fanout.cu``)
LANE_TILE = 1024
SLOT_TILE = 1024

Expansion = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2**32, read as int32 (the int32 wrap of JAX)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _check(csr_keys, csr_offsets, csr_dst, src_keys, valid) -> None:
    dev = src_keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t, dtype in (("src_keys", src_keys, torch.int32),
                           ("valid", valid, torch.bool),
                           ("csr_keys", csr_keys, torch.int32),
                           ("csr_offsets", csr_offsets, torch.int32),
                           ("csr_dst", csr_dst, torch.int32)):
        _check_vector(name, t, dtype, dev)
    if valid.shape != src_keys.shape:
        raise ValueError(f"valid {tuple(valid.shape)} != src_keys "
                         f"{tuple(src_keys.shape)}")
    if csr_keys.shape[0] == 0 \
            or csr_offsets.shape[0] != csr_keys.shape[0] + 1:
        raise ValueError("the graph needs at least one source row and one "
                         "offset more than sources")


def _empty(width: int, device: torch.device, n_dropped) -> Expansion:
    """The expansion of no messages: every slot invalid."""
    return (torch.full((width,), KEY_SENTINEL, dtype=torch.int32,
                       device=device),
            torch.zeros(width, dtype=torch.int32, device=device),
            torch.zeros(width, dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros(0, dtype=torch.bool, device=device),
            n_dropped)


def _bisect_right(offs: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The upper bound of each ``j`` in ``offs`` by the reference's
    bisection (``jnp.searchsorted(side="right")``'s default method):
    ``ceil(log2(m + 1))`` steps from ``(low, high) = (0, m)``, each
    ``mid = (low + high) // 2`` (uint32 in the reference; no sum here
    passes 2**32), going left where ``j < offs[mid]``; the answer is
    ``high``.  On a monotone ``offs`` it is the upper bound; where the
    int32 scan wrapped and ``offs`` is not monotone, it is the
    reference's own answer, which another bisection need not give."""
    m = offs.shape[0]
    low = torch.zeros(j.shape, dtype=torch.int64, device=j.device)
    high = torch.full(j.shape, m, dtype=torch.int64, device=j.device)
    for _ in range(m.bit_length()):  # ceil(log2(m + 1))
        mid = (low + high) // 2  # < m while low < high
        go_left = j < offs[mid.clamp(max=m - 1)]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def fanout_expand_plain(csr_keys: torch.Tensor, csr_offsets: torch.Tensor,
                        csr_dst: torch.Tensor, src_keys: torch.Tensor,
                        valid: torch.Tensor, n_dropped=None) -> Expansion:
    """Plain PyTorch version of ``fanout_expand``."""
    n, width, m = csr_keys.shape[0], csr_dst.shape[0], src_keys.shape[0]
    count = _miss_counter(n_dropped, src_keys)
    if m == 0:
        return _empty(width, src_keys.device, count)
    idx = torch.searchsorted(csr_keys, src_keys).clamp_(0, n - 1)
    hit = valid & (csr_keys[idx] == src_keys)
    deg = torch.where(hit, csr_offsets[idx + 1] - csr_offsets[idx], 0)
    start = torch.where(hit, csr_offsets[idx], 0)
    offs = _wrap32(torch.cumsum(deg.to(torch.int64), 0))
    total = offs[-1].clone()
    src_dropped = hit & (deg > 0) & (offs > width)
    count += src_dropped.sum(dtype=torch.int32)
    j = torch.arange(width, dtype=torch.int32, device=src_keys.device)
    src = _bisect_right(offs, j).clamp_(0, m - 1)
    before = torch.where(src > 0, offs[(src - 1).clamp(min=0)], 0)
    e = _wrap32(start[src].to(torch.int64) + (j - before).to(torch.int64))
    out_valid = (j < total) & (offs[src] <= width)
    dst = torch.where(out_valid, csr_dst[e.clamp(0, max(width - 1, 0))],
                      KEY_SENTINEL)
    return dst, src.to(torch.int32), out_valid, total, src_dropped, count


@_build.counted
def fanout_expand(csr_keys: torch.Tensor, csr_offsets: torch.Tensor,
                  csr_dst: torch.Tensor, src_keys: torch.Tensor,
                  valid: torch.Tensor, n_dropped=None) -> Expansion:
    """Expand ``m`` source messages into ``len(csr_dst)`` destination
    slots (see the module docstring for the outputs)."""
    _check(csr_keys, csr_offsets, csr_dst, src_keys, valid)
    if src_keys.device.type == "cpu":
        return fanout_expand_plain(csr_keys, csr_offsets, csr_dst, src_keys,
                                   valid, n_dropped)
    dev = src_keys.device
    width, m = csr_dst.shape[0], src_keys.shape[0]
    count = _miss_counter(n_dropped, src_keys)
    if m == 0:
        return _empty(width, dev, count)

    def i32(n: int) -> torch.Tensor:
        return torch.empty(n, dtype=torch.int32, device=dev)

    start, offs = i32(m), i32(m)
    # the lane pass's look-back: a status word a lane tile, zero, and left
    # so by every launch (its slot pass clears what the lane pass used)
    words = _build.stream_pool(
        "fanout_expand", dev,
        lambda n: torch.zeros(n, dtype=torch.int64, device=dev),
        max(-(-m // LANE_TILE), 256))
    tile_owner = i32(-(-width // SLOT_TILE) + 1)  # and the wrap flag
    dst, src_index = i32(width), i32(width)
    out_valid = torch.empty(width, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    src_dropped = torch.empty(m, dtype=torch.bool, device=dev)
    lib = _build.library("fanout", _SIGNATURES)
    err = lib.fanout_expand(
        csr_keys.data_ptr(), csr_offsets.data_ptr(), csr_keys.shape[0],
        csr_dst.data_ptr(), width, src_keys.data_ptr(), valid.data_ptr(), m,
        start.data_ptr(), offs.data_ptr(), words.data_ptr(),
        tile_owner.data_ptr(), dst.data_ptr(), src_index.data_ptr(),
        out_valid.data_ptr(), total.data_ptr(), src_dropped.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _build.drop_pool("fanout_expand", dev)
    _build.check(lib, err, "fanout_expand")
    _build.note_launch(fanout_expand)
    return dst, src_index, out_valid, total, src_dropped, count
