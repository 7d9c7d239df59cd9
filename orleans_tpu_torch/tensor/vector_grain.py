"""Vector grains: grain types whose activations live as tensor rows.

The port of ``orleans_tpu/tensor/vector_grain.py``.  A ``VectorGrain``
declares its per-activation state as typed fields; every activation of the
type occupies one row of a dict of state columns, and its methods are
*batched*: one call processes every message sent to any activation of the
type this round (reference: ActivationData.cs:42, WorkItemGroup.cs:36 —
single-threaded turn semantics hold because each row is updated by one
kernel per round, with fan-in combined by segment reductions).

Handler contract::

    @vector_grain
    class GameGrain(VectorGrain):
        score = field(torch.float32, 0.0)

        @batched_method
        @staticmethod
        def update(state, batch: Batch, n_rows):
            # state: dict of [N, ...] tensors (the whole arena)
            # batch.rows: int32[M] destination row per message (-1 = pad)
            # batch.args: dict of [M, ...] tensors or host scalars
            total = seg_sum(batch.args["delta"], batch.rows, n_rows)
            return {**state, "score": state["score"] + total}, None, ()

**In place.**  ``scatter_rows`` and ``scatter_add_rows`` update the column
they are given in place and return it — the counterpart of the JAX
package's donated state (``TensorEngineConfig.donate_state=True``, the
default).  With ``donate_state=False`` the engine's step clones the
columns before the handler runs, so the arena's live columns stay intact.
Handlers never mutate ``batch.rows`` or ``batch.args``: the engine keeps
them for redelivery of missed messages.

On CUDA tensors every primitive here runs a hand-written kernel
(``orleans_tpu_torch/kernels``); on CPU tensors, its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from orleans_tpu_torch.core.grain import (
    InterfaceInfo,
    MethodInfo,
    batched_method,  # noqa: F401 — re-exported for convenience
    method_id_of,
)
from orleans_tpu_torch.ids import type_code_of
from orleans_tpu_torch.kernels import pull as _pull
from orleans_tpu_torch.kernels import segment as _segment
from orleans_tpu_torch.kernels.lifecycle import gather_rows
from orleans_tpu_torch.kernels.resolve import KEY_SENTINEL  # noqa: F401
from orleans_tpu_torch.kernels.scatter import Values, row_scatter


def ones_mask(n: int, device: torch.device) -> torch.Tensor:
    """An all-true lane mask of length ``n``."""
    return torch.ones(n, dtype=torch.bool, device=device)


@dataclass(frozen=True)
class StateField:
    """One per-activation state column.

    ``fold`` names the replica-merge reduction for hot-grain replication
    ("sum", "max" or "min"); kept for parity with the JAX declaration."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Any  # scalar broadcast to shape
    fold: str = "sum"


def field(dtype: torch.dtype, init=0, shape: Tuple[int, ...] = (),
          fold: str = "sum") -> StateField:
    return StateField(shape=tuple(shape), dtype=dtype, init=init, fold=fold)


class Batch(NamedTuple):
    """The messages for one (type, method) this round.

    ``rows`` is -1 for padding and unresolved lanes; the scatter helpers
    drop them, so handlers rarely need ``mask``.

    ``segments`` is the pull-mode fan-in layout of the streams plane
    (``tensor/streams_plane.py``): the lanes are grouped by destination
    row and ``segments`` (int32 ``[n_rows + 1]``) gives arena row ``r``
    the lanes ``[segments[r], segments[r + 1])``.  ``seg_sum`` and
    ``seg_max`` then reduce each row's range (K16) instead of
    scattering."""

    rows: torch.Tensor         # int32[M], -1 = padding
    args: Any                  # dict of [M, ...] tensors / host scalars
    mask: torch.Tensor         # bool[M]
    # row-aligned pull-mode offsets (int32[n_rows + 1]); None = lanes in
    # any order, reductions take the scatter path
    segments: Optional[torch.Tensor] = None


@dataclass
class Emit:
    """Messages emitted by a handler to another vector grain type.

    ``keys`` are grain primary keys (int32, not rows), or wide keys in
    ``[0, 2**63)`` as an ``(hi, lo)`` pair of int32 word tensors
    (``arena.split_wide_keys``): the engine resolves key→row on the
    destination type's arena on the device, auto-activating unseen keys
    at the next miss-check drain (reference: Dispatcher.cs:555,
    Catalog.cs:411)."""

    interface: str
    method: str
    keys: Any                  # int32[M'] grain keys (may repeat) | (hi, lo)
    args: Any                  # dict of [M', ...]
    mask: Optional[torch.Tensor] = None  # bool[M']; None = all valid


# ---------------------------------------------------------------------------
# segment helpers (fan-in combiners)
# ---------------------------------------------------------------------------

def seg_sum(values: torch.Tensor, rows: torch.Tensor, n_rows: int,
            segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum ``values`` per destination row; padding rows (-1) are dropped
    (the batched analog of a mailbox drain of commutative updates).

    With ``segments`` (``Batch.segments``) the reduction is pull-mode:
    each row sums its own lane range (K16) and ``rows`` is not read.
    int32 sums wrap as JAX's do; a float32 row sum is taken in lane order,
    within ``2**-24 * sum|x|`` of the row's exact sum (JAX's prefix-sum
    difference drifts with the batch's total instead)."""
    if segments is not None:
        return _pull.seg_pull(values, segments, "sum")
    return _segment.seg_sum(values, rows, n_rows)


def seg_max(values: torch.Tensor, rows: torch.Tensor, n_rows: int,
            segments: Optional[torch.Tensor] = None,
            fill=0) -> torch.Tensor:
    """Max of ``values`` per destination row (padding rows dropped).  Rows
    with no lanes read the dtype's minimum (``-inf`` for floats), which is
    ``jax.ops.segment_max``'s identity; on the pull-mode path
    (``segments``, K16) they read ``fill``, as in the JAX package."""
    if segments is not None:
        return _pull.seg_pull(values, segments, "max", fill=fill)
    if values.dtype.is_floating_point:
        lowest = float("-inf")
    else:
        lowest = torch.iinfo(values.dtype).min
    out = torch.full((n_rows, *values.shape[1:]), lowest,
                     dtype=values.dtype, device=values.device)
    return row_scatter(out, rows, values, "max")


def seg_mean(values: torch.Tensor, rows: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    total = seg_sum(values, rows, n_rows)
    ones = torch.ones(values.shape[0], dtype=values.dtype,
                      device=values.device)
    count = seg_sum(ones, rows, n_rows)
    return total / torch.clamp(count, min=1)


def scatter_rows(column: torch.Tensor, rows: torch.Tensor,
                 values: Values) -> torch.Tensor:
    """``column[rows] = values`` in place; padding rows (-1) and rows past
    the end are dropped.  For duplicate rows one writer wins, not a chosen
    one (use seg_* for order-free combining)."""
    return row_scatter(column, rows, values, "set")


def scatter_add_rows(column: torch.Tensor, rows: torch.Tensor,
                     values: Values) -> torch.Tensor:
    """``column[rows] += values`` in place, padding rows dropped."""
    return row_scatter(column, rows, values, "add")


def gather_fill(column: torch.Tensor, rows: torch.Tensor,
                fill) -> torch.Tensor:
    """``column[rows]`` with ``fill`` for padding rows (-1) and rows past
    the end (JAX's ``column.at[rows].get(mode="fill")``): one K13 gather
    and a select."""
    out = gather_rows(column, rows)
    ok = (rows >= 0) & (rows < column.shape[0])
    return torch.where(ok.reshape(-1, *([1] * (column.dim() - 1))), out,
                       fill)


# ---------------------------------------------------------------------------
# declaration
# ---------------------------------------------------------------------------

class VectorGrain:
    """Base marker for tensor-path grain types."""

    __vector_grain__ = True


@dataclass
class VectorGrainInfo:
    cls: type
    name: str
    type_code: int
    interface: InterfaceInfo
    state_fields: Dict[str, StateField]
    handlers: Dict[str, Callable]       # method name → handler fn
    methods: Dict[str, MethodInfo]


_VECTOR_TYPES: Dict[str, VectorGrainInfo] = {}
_VECTOR_BY_CODE: Dict[int, VectorGrainInfo] = {}


def vector_grain(cls: type) -> type:
    """Register a VectorGrain subclass: collect its state fields and
    batched handlers under its name and type code."""
    state_fields: Dict[str, StateField] = {}
    handlers: Dict[str, Callable] = {}
    methods: Dict[str, MethodInfo] = {}
    for name, attr in list(vars(cls).items()):
        if isinstance(attr, StateField):
            state_fields[name] = attr
        elif getattr(attr, "__grain_batched__", False):
            fn = attr.__func__ if isinstance(attr, staticmethod) else attr
            handlers[name] = fn
            methods[name] = MethodInfo(
                name=name, method_id=method_id_of(name),
                one_way=getattr(fn, "__grain_one_way__", False),
                batched=True,
                commutative=getattr(fn, "__grain_commutative__", False))
    iface = InterfaceInfo(name=cls.__name__,
                          interface_id=type_code_of(cls.__name__), cls=cls)
    for m in methods.values():
        iface.add(m)
    cls.__grain_interface_info__ = iface
    info = VectorGrainInfo(
        cls=cls, name=cls.__name__, type_code=type_code_of(cls.__name__),
        interface=iface, state_fields=state_fields, handlers=handlers,
        methods=methods)
    _VECTOR_TYPES[cls.__name__] = info
    _VECTOR_BY_CODE[info.type_code] = info
    return cls


def vector_type(name_or_code) -> Optional[VectorGrainInfo]:
    if isinstance(name_or_code, int):
        return _VECTOR_BY_CODE.get(name_or_code)
    return _VECTOR_TYPES.get(name_or_code)


def all_vector_types() -> Dict[str, VectorGrainInfo]:
    return dict(_VECTOR_TYPES)
