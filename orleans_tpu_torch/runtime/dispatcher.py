"""Dispatcher: message routing and forwarding (the part of
``orleans_tpu/runtime/dispatcher.py`` the clustered vector data plane
needs).

Parity: reference Dispatcher (reference: src/OrleansRuntime/Core/
Dispatcher.cs:38 — ReceiveMessage :78, TryForwardRequest :474,
AsyncSendMessage :519).  Responses resolve their caller's callback,
system-target messages run on the silo, and a vector grain's message is
bridged into the tensor engine — or forwarded to the ring owner of its
key when that is another silo, so a vector grain's row exists on one
silo only.  Host-grain activation belongs to a later slice.
"""

from __future__ import annotations

import asyncio

from orleans_tpu_torch.runtime.messaging import (
    Direction,
    Message,
    RejectionType,
    ResponseKind,
)
from orleans_tpu_torch.tensor.vector_grain import vector_type


class Dispatcher:
    """Forward limit comes from MessagingConfig.max_forward_count via
    silo.max_forward_count (reference: Constants MaxForwardCount)."""

    def __init__(self, silo) -> None:
        self.silo = silo
        self.metrics = silo.metrics

    @property
    def runtime_client(self):
        return self.silo.runtime_client

    def receive_message(self, msg: Message) -> None:
        """(reference: Dispatcher.ReceiveMessage :78)"""
        self.metrics.dispatcher_received += 1
        if msg.direction == Direction.RESPONSE:
            self.runtime_client.receive_response(msg)
            return
        if msg.is_expired():
            if msg.direction == Direction.REQUEST:
                self._respond(msg.create_rejection(
                    RejectionType.EXPIRED, "request expired in transit"))
            return
        if msg.target_grain is not None and msg.target_grain.is_system_target:
            self.silo.invoke_system_target(msg)
            return
        vt = vector_type(msg.target_grain.type_code) \
            if msg.target_grain is not None else None
        if vt is None:
            self._respond_error(msg, NotImplementedError(
                f"{msg.target_grain}: host grains belong to a later slice "
                f"of the port"))
            return
        self._bridge_to_engine(vt, msg)

    def _bridge_to_engine(self, vt, msg: Message) -> None:
        engine = self.silo.tensor_engine
        if engine is None:
            self._respond_error(msg, RuntimeError(
                "vector grain message but tensor engine disabled"))
            return
        # single-activation: a vector grain's arena row lives ONLY on its
        # ring owner — non-owners forward instead of injecting into their
        # own engine (reference: Catalog.cs:533-563; LocalGrainDirectory
        # .cs:510)
        if self.silo.vector_router is not None:
            owner = self.silo.ring.calculate_target_silo(msg.target_grain)
            if owner is not None and owner != self.silo.address:
                msg.target_silo = owner
                self.try_forward(msg, f"vector grain owned by {owner}")
                return
        minfo = vt.methods.get(msg.method_name)
        if minfo is None:
            self._respond_error(msg, AttributeError(
                f"{vt.name} has no batched method {msg.method_name!r}"))
            return
        fut = engine.send_one(msg.target_grain, minfo, msg.args)
        if fut is None or msg.direction == Direction.ONE_WAY:
            return

        def relay(f: asyncio.Future) -> None:
            if f.exception() is not None:
                self._respond_error(msg, f.exception())
            else:
                self._respond(msg.create_response(f.result()))

        fut.add_done_callback(relay)

    def send_message(self, msg: Message) -> None:
        """(reference: Dispatcher.AsyncSendMessage :519) — a vector
        grain's message without a target silo goes to its ring owner."""
        if msg.target_silo is None and msg.target_grain is not None:
            msg.target_silo = self.silo.ring.calculate_target_silo(
                msg.target_grain)
        self.silo.message_center.send_message(msg)

    def try_forward(self, msg: Message, reason: str) -> None:
        """(reference: Dispatcher.TryForwardRequest :474)"""
        if msg.direction == Direction.RESPONSE:
            return
        msg.forward_count += 1
        if msg.forward_count > self.silo.max_forward_count:
            self.metrics.rejections_sent += 1
            self._respond(msg.create_rejection(
                RejectionType.UNRECOVERABLE,
                f"exceeded max forward count ({reason})"))
            return
        self.metrics.messages_forwarded += 1
        if msg.target_silo == self.silo.address:
            msg.target_silo = None
        if msg.target_silo is None:
            msg.target_activation = None
        self.send_message(msg)

    def _respond(self, response: Message) -> None:
        self.silo.message_center.send_message(response)

    def _respond_error(self, msg: Message, exc: Exception) -> None:
        if msg.direction == Direction.ONE_WAY:
            return
        self._respond(msg.create_response(exc, ResponseKind.ERROR))
