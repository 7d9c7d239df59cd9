"""Method and interface metadata for vector grains (the part of
``orleans_tpu/core/grain.py`` the port needs: the typed method table and
the method decorators; reference: src/Orleans/Core/GrainAttributes.cs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from orleans_tpu_torch.hashing import jenkins_hash


@dataclass
class MethodInfo:
    """One entry of the typed method table (replaces codegen'd invokers)."""

    name: str
    method_id: int
    read_only: bool = False
    one_way: bool = False
    always_interleave: bool = False
    batched: bool = False  # tensor-path handler
    # commutative/mergeable: the handler's state updates fold across
    # replica rows by the declared per-field reduction
    commutative: bool = False


@dataclass
class InterfaceInfo:
    name: str
    interface_id: int
    methods_by_id: Dict[int, MethodInfo] = field(default_factory=dict)
    methods_by_name: Dict[str, MethodInfo] = field(default_factory=dict)
    cls: Optional[type] = None

    def add(self, m: MethodInfo) -> None:
        self.methods_by_id[m.method_id] = m
        self.methods_by_name[m.name] = m


def method_id_of(name: str) -> int:
    """Stable method id (reference: codegen'd per-method integer ids)."""
    return jenkins_hash(("m:" + name).encode("utf-8")) & 0x7FFFFFFF


def one_way(fn: Callable) -> Callable:
    """[OneWay] — fire-and-forget; no response message is sent."""
    fn.__grain_one_way__ = True
    return fn


def batched_method(fn: Callable) -> Callable:
    """Tensor-path handler ``fn(state, batch, n_rows) -> (state,
    results, emits)`` over stacked activations (see tensor/engine.py)."""
    fn.__grain_batched__ = True
    return fn


def commutative(fn: Callable) -> Callable:
    """Declare a handler commutative/mergeable: its state updates are
    order-independent and distribute over the grain's per-field fold
    reductions (the contract hot-grain replication requires)."""
    fn.__grain_commutative__ = True
    return fn
