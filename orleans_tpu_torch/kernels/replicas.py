"""K18 ``spread_replicas``: the hot-grain replica spread of resolved rows.

Replaces ``orleans_tpu/tensor/arena.py`` ``_spread_replicas_kernel``.  A
grain promoted to a replica group (``GrainArena.promote_replicas``) keeps
its PRIMARY row in the directory; delivery re-points each lane whose
resolved row is a replicated primary to one of the group's rows, chosen
by the lane's position: ``table[idx, ((lane * 2654435761) mod 2**32 >> 8)
mod counts[idx]]``.  Misses (-1) and the rows of unreplicated grains pass
through unchanged, and no miss count is touched.

The mirror is ``GrainArena.replica_mirror``: ``prim`` (int32 ``[G]``, the
sorted primary rows pow2-padded with ``2**31 - 1``), ``counts`` (int32
``[G]``, padded with 1) and ``table`` (int32 ``[G, 8]``, padded with -1).
The plain version computes the hash in int64 masked to 32 bits (the CPU
has no reliable uint32 multiply); it equals the JAX kernel and the
arena's host twin ``spread_rows_host`` bit for bit.

The wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors.  What bounds the kernel on an H100 and what it
does about it is in the note at the top of ``csrc/replicas.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from orleans_tpu_torch.kernels import _build
from orleans_tpu_torch.kernels.attr import _M32, _mul32

#: replica rows a group's table row holds (``GrainArena.
#: REPLICA_TABLE_WIDTH``; the kernel's ``kTableWidth``)
TABLE_WIDTH = 8
#: the lane hash's multiplier (Knuth's multiplicative constant)
LANE_HASH = 2654435761

_P = ctypes.c_void_p
_SIGNATURES = {"spread_replicas": (_P, _P, _P, ctypes.c_int32, _P, _P,
                                   ctypes.c_int64, _P)}


def _check(prim: torch.Tensor, counts: torch.Tensor, table: torch.Tensor,
           rows: torch.Tensor) -> None:
    for name, t, dim in (("prim", prim, 1), ("counts", counts, 1),
                         ("table", table, 2), ("rows", rows, 1)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != dim or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dim}-D int32 "
                            f"tensor")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on "
                             f"{rows.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    g = prim.shape[0]
    if g == 0 or counts.shape != (g,) or table.shape != (g, TABLE_WIDTH):
        raise ValueError(f"mirror shapes prim {tuple(prim.shape)}, counts "
                         f"{tuple(counts.shape)}, table "
                         f"{tuple(table.shape)}: want [G], [G], "
                         f"[G, {TABLE_WIDTH}] with G > 0")


def spread_replicas_plain(prim: torch.Tensor, counts: torch.Tensor,
                          table: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of ``spread_replicas``."""
    g = prim.shape[0]
    idx = torch.searchsorted(prim, rows, side="left").clamp_(0, g - 1)
    hit = (prim[idx] == rows) & (rows >= 0)
    lanes = torch.arange(rows.shape[0], dtype=torch.int64,
                         device=rows.device) & _M32
    h = _mul32(lanes, LANE_HASH) >> 8
    choice = h % counts[idx].to(torch.int64)
    alt = table[idx, choice]
    return torch.where(hit & (alt >= 0), alt, rows)


@_build.counted
def spread_replicas(prim: torch.Tensor, counts: torch.Tensor,
                    table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The spread rows as a new int32 ``[m]`` tensor: a lane whose row is a
    replicated primary takes the replica row its lane hash picks; every
    other lane keeps its row."""
    _check(prim, counts, table, rows)
    if rows.device.type == "cpu":
        return spread_replicas_plain(prim, counts, table, rows)
    m = rows.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=rows.device)
    if m == 0:
        return out
    lib = _build.library("replicas", _SIGNATURES)
    err = lib.spread_replicas(
        prim.data_ptr(), counts.data_ptr(), table.data_ptr(), prim.shape[0],
        rows.data_ptr(), out.data_ptr(), m,
        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(lib, err, "spread_replicas")
    _build.note_launch(spread_replicas)
    return out
