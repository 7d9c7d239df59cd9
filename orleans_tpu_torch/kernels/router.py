"""The cross-silo router's kernel.

K22 ``gather_args``: rows ``idx`` along axis 0 of every non-scalar leaf of
a message payload tree, scalar leaves passing through (replaces
``orleans_tpu/tensor/router.py`` ``_gather_args_dev``).  ``idx`` may be
cut into segments (``bounds``): a ``ClusterInjector``'s ownership split
is one permutation of its lanes — the local lanes, then each remote
destination's — and one launch gathers every (segment, leaf) piece into
one packed uint8 buffer, segment-major, each piece at a 16-byte aligned
offset.  The local segment's leaves are views for the local injector;
the remote segments form one contiguous region, which ``fetch_segments``
brings to the host with one copy into pinned memory.  Leaves of any
trailing shape and dtype; indices outside ``[0, n)`` clip.

The plain version (``gather_args_plain``: one ``index_select`` per piece
into the same layout) is what a CPU tensor takes; a CUDA tensor launches
K22 or raises.  Kernel and plain version agree bit for bit.

The kernel is bound by bytes: the rows read and written and the indices
read once.  ``plan_gather`` plans its blocks here, on the host: each
block covers ``LANES_PER_BLOCK`` consecutive lanes of one segment for
every leaf of the launch, so a block knows its segment from its index
alone; a thread keeps its ``LANES_PER_THREAD`` lanes' indices for every
leaf and writes a narrow leaf's lanes with one vector store.  The note at
the top of ``csrc/router.cu`` has the rest.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from orleans_tpu_torch.kernels import _build

#: the kernel's block geometry and its per-launch table limits
#: (csrc/router.cu)
LANES_PER_THREAD = 4
LANES_PER_BLOCK = 256 * LANES_PER_THREAD
MAX_LEAVES = 8
MAX_SEGMENTS = 16
_ALIGN = 16
#: row widths the 4-lane path takes (one vector store of 4 lanes)
_NARROW = (1, 2, 4, 8)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_SIGNATURES = {
    "gather_args": (_I32, _P, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _P),
}


def _table(values, ctype) -> ctypes.Array:
    return (ctype * len(values))(*values)


def _unit(*quantities: int) -> int:
    """The widest unit (16, 8, 4 or 1 bytes) dividing every quantity."""
    for u in (16, 8, 4):
        if all(q % u == 0 for q in quantities):
            return u
    return 1


def _row_bytes(leaf: torch.Tensor) -> int:
    return int(np.prod(leaf.shape[1:], dtype=np.int64)) * leaf.element_size()


@dataclass
class SplitLayout:
    """Where each (segment, leaf) piece lives in the packed buffer:
    ``offs[s][l]`` bytes from its start; segment ``s`` spans
    ``[seg_start[s], seg_start[s + 1])``."""

    counts: List[int]
    offs: List[List[int]]
    seg_start: List[int]

    @property
    def size(self) -> int:
        return self.seg_start[-1]


def split_layout(leaves: Sequence[torch.Tensor],
                 counts: Sequence[int]) -> SplitLayout:
    """The packed layout of ``len(counts)`` segments of ``counts[s]``
    lanes each over ``leaves``: segment-major, every piece 16-byte
    aligned, so a segment's pieces are one contiguous byte range."""
    offs, starts, end = [], [], 0
    for m in counts:
        starts.append(end)
        row = []
        for leaf in leaves:
            row.append(end)
            end = -(-(end + m * _row_bytes(leaf)) // _ALIGN) * _ALIGN
        offs.append(row)
    starts.append(end)
    return SplitLayout(list(counts), offs, starts)


def split_views(staging: torch.Tensor, leaves: Sequence[torch.Tensor],
                layout: SplitLayout, first: int = 0, base: int = 0
                ) -> List[List[Any]]:
    """Per segment (from ``first``), the ``[m, *width]`` output of each
    leaf inside ``staging`` (which starts at byte ``base`` of the
    layout); tensors, or numpy arrays for a numpy ``staging``."""
    out = []
    for s in range(first, len(layout.counts)):
        m = layout.counts[s]
        seg = []
        for leaf, off in zip(leaves, layout.offs[s]):
            lo = off - base
            nbytes = m * _row_bytes(leaf)
            v = staging[lo:lo + nbytes]
            if isinstance(v, np.ndarray):
                seg.append(v.view(np_dtype(leaf.dtype)).reshape(
                    m, *leaf.shape[1:]))
            else:
                seg.append(v.view(leaf.dtype).view(m, *leaf.shape[1:]))
        out.append(seg)
    return out


def np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _counts(m: int, bounds: Optional[Sequence[int]]) -> List[int]:
    if bounds is None:
        return [m]
    bounds = list(bounds)
    if bounds[0] != 0 or bounds[-1] != m or any(
            b < a for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"bounds {bounds} do not cut {m} lanes in order")
    return [b - a for a, b in zip(bounds, bounds[1:])]


def _check(leaves: Sequence[torch.Tensor], idx: torch.Tensor) -> None:
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32 \
            or idx.dim() != 1 or not idx.is_contiguous():
        raise TypeError("idx must be a contiguous 1-D int32 tensor")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {idx.device}")
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1 \
                or not leaf.is_contiguous():
            raise TypeError(f"leaf {i} must be a contiguous tensor with a "
                            f"leading lane axis")
        if leaf.device != idx.device:
            raise ValueError(f"leaf {i} on {leaf.device}, idx on "
                             f"{idx.device}")
        if leaf.shape[0] == 0 and idx.shape[0]:
            raise ValueError(f"leaf {i} has no rows to gather from")


@dataclass
class GatherLaunch:
    """One launch of K22: its non-empty segments (first lane of ``idx``,
    lanes, first block; ``block0`` has one more entry, the grid size) and
    its leaves (indices into the call's leaves), with each (segment,
    leaf) piece's byte offset in the packed buffer.  Block ``b`` belongs
    to the last segment ``s`` with ``block0[s] <= b`` and covers its
    lanes from ``(b - block0[s]) * LANES_PER_BLOCK``, as the kernel
    finds them."""

    segments: List[int]
    lane0: List[int]
    lanes: List[int]
    block0: List[int]
    leaves: List[int]
    offs: List[List[int]]


def plan_gather(layout: SplitLayout, leaves: Sequence[int]
                ) -> List[GatherLaunch]:
    """K22's launches for a packed split of the given leaves (indices into
    the layout's): the non-empty segments in groups of ``MAX_SEGMENTS``
    times the leaves in groups of ``MAX_LEAVES``; in each launch segment
    ``s`` owns blocks ``[block0[s], block0[s + 1])``,
    ``ceil(lanes / LANES_PER_BLOCK)`` of them."""
    segs, lane = [], 0
    for s, m in enumerate(layout.counts):
        if m:
            segs.append((s, lane, m))
        lane += m
    leaves = list(leaves)
    out = []
    for g in range(0, len(segs), MAX_SEGMENTS):
        group = segs[g:g + MAX_SEGMENTS]
        block0 = [0]
        for _s, _l, m in group:
            block0.append(block0[-1] + -(-m // LANES_PER_BLOCK))
        for f in range(0, len(leaves), MAX_LEAVES):
            part = leaves[f:f + MAX_LEAVES]
            out.append(GatherLaunch(
                [s for s, _l, _m in group], [l for _s, l, _m in group],
                [m for _s, _l, m in group], block0, part,
                [[layout.offs[s][j] for j in part] for s, _l, _m in group]))
    return out


def _leaf_mode(leaf: torch.Tensor) -> Tuple[int, int]:
    """(row bytes, unit): unit 0 sends the leaf down the 4-lane path (a
    row of 1, 2, 4 or 8 bytes at an address it divides); any other leaf
    copies rows in the widest unit dividing its row and address."""
    row = _row_bytes(leaf)
    if row in _NARROW and leaf.data_ptr() % row == 0:
        return row, 0
    return row, _unit(leaf.data_ptr(), row)


def gather_args_plain(leaves: Sequence[torch.Tensor], idx: torch.Tensor,
                      bounds: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, List[List[torch.Tensor]],
                                 SplitLayout]:
    """Plain PyTorch version of ``gather_args``: one ``index_select`` per
    piece into the same packed layout."""
    leaves = list(leaves)
    layout = split_layout(leaves, _counts(idx.shape[0], bounds))
    staging = torch.zeros(layout.size, dtype=torch.uint8, device=idx.device)
    views = split_views(staging, leaves, layout)
    lane = 0
    for s, m in enumerate(layout.counts):
        part = idx[lane:lane + m].long()
        for leaf, v in zip(leaves, views[s]):
            if m:
                v.copy_(leaf.index_select(
                    0, part.clamp(0, leaf.shape[0] - 1)))
        lane += m
    return staging, views, layout


@_build.counted
def gather_args(leaves: Sequence[torch.Tensor], idx: torch.Tensor,
                bounds: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, List[List[torch.Tensor]],
                           SplitLayout]:
    """Every leaf's rows ``idx`` (segment by segment when ``bounds`` cut
    ``idx``) in one launch per ``MAX_SEGMENTS`` non-empty segments and
    ``MAX_LEAVES`` leaves: returns the uint8 staging buffer, per segment
    each leaf's ``[m_s, *width]`` view into it, and the layout."""
    leaves = list(leaves)
    _check(leaves, idx)
    if idx.device.type == "cpu":
        return gather_args_plain(leaves, idx, bounds)
    layout = split_layout(leaves, _counts(idx.shape[0], bounds))
    staging = torch.empty(layout.size, dtype=torch.uint8, device=idx.device)
    views = split_views(staging, leaves, layout)
    live = [j for j, leaf in enumerate(leaves) if _row_bytes(leaf)]
    if not live or not idx.shape[0]:
        return staging, views, layout
    modes = {j: _leaf_mode(leaves[j]) for j in live}
    lib = _build.library("router", _SIGNATURES)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    for launch in plan_gather(layout, live):
        picked = launch.leaves
        err = lib.gather_args(
            len(launch.lanes), _table(launch.lane0, i64),
            _table(launch.lanes, i64), _table(launch.block0, i64),
            _table([o for row in launch.offs for o in row], i64),
            len(picked), _table([leaves[j].data_ptr() for j in picked], i64),
            _table([leaves[j].shape[0] for j in picked], i64),
            _table([modes[j][0] for j in picked], i32),
            _table([modes[j][1] for j in picked], i32),
            idx.data_ptr(), staging.data_ptr(), stream)
        _build.check(lib, err, "gather_args")
        _build.note_launch(gather_args)
    return staging, views, layout


# -- the payload tree ------------------------------------------------------

def is_scalar_leaf(a: Any) -> bool:
    """A leaf that passes through the gather (``jnp.ndim(a) == 0``)."""
    if isinstance(a, torch.Tensor):
        return a.dim() == 0
    return np.ndim(a) == 0


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a dict/list/tuple tree, in walk order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_replace(tree: Any, new: List[Any]) -> Any:
    """``tree`` with its non-scalar leaves replaced, in walk order, by
    ``new``."""
    it = iter(new)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if x is None or is_scalar_leaf(x):
            return x
        return next(it)

    return walk(tree)


def payload_leaves(args: Any, device: torch.device) -> List[torch.Tensor]:
    """The non-scalar leaves of ``args`` as contiguous tensors on
    ``device`` (host arrays are uploaded, as the JAX program takes them
    onto the device)."""
    out = []
    for a in tree_leaves(args):
        if is_scalar_leaf(a):
            continue
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out.append(a.to(device).contiguous())
    return out


def gather_tree(args: Any, idx: torch.Tensor,
                bounds: Optional[Sequence[int]] = None):
    """``_gather_args_dev`` over a tree, per segment: returns the staging
    buffer, the layout, the gathered leaves' sources and one tree per
    segment (views into the staging buffer; scalars pass through)."""
    leaves = payload_leaves(args, idx.device)
    staging, views, layout = gather_args(leaves, idx, bounds)
    return staging, layout, leaves, [tree_replace(args, v) for v in views]


def fetch_segments(staging: torch.Tensor, layout: SplitLayout,
                   leaves: Sequence[torch.Tensor], args: Any,
                   first: int = 1) -> List[Any]:
    """Segments ``first..`` of a packed gather as host trees: one
    device-to-host copy of their contiguous byte range into pinned
    memory, one wait, then numpy views per leaf (scalars pass
    through)."""
    lo, hi = layout.seg_start[first], layout.seg_start[-1]
    region = staging[lo:hi]
    if staging.device.type == "cuda":
        host = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=True)
        host.copy_(region, non_blocking=True)
        torch.cuda.current_stream(staging.device).synchronize()
    else:
        host = region.clone()
    views = split_views(host.numpy(), leaves, layout, first=first, base=lo)
    return [tree_replace(args, v) for v in views]
