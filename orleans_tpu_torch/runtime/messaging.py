"""Message envelope + silo message center (the part of
``orleans_tpu/runtime/messaging.py`` the clustered vector data plane
needs).

Parity: the reference's ``Message`` (reference: src/Orleans/Messaging/
Message.cs:35-145 — Categories :117, Directions :124, RejectionTypes
:138) and ``MessageCenter`` (reference: MessageCenter.cs:33).  The
envelope is the control-plane unit: system traffic, vector slabs between
silos and per-message vector calls.  Circuit breakers and the batched RPC
fabric belong to a later slice, so ``send_message`` hands a remote
message straight to the transport, as the JAX package does when both are
absent.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Dict, List, Optional, Tuple

from orleans_tpu_torch.codec import default_manager as _codec
from orleans_tpu_torch.ids import (
    ActivationAddress,
    ActivationId,
    GrainId,
    SiloAddress,
    SystemTargetCodes,
)


class Category(IntEnum):
    """(reference: Message.cs Categories :117)"""

    PING = 1
    SYSTEM = 2
    APPLICATION = 3


class Direction(IntEnum):
    """(reference: Message.cs Directions :124)"""

    REQUEST = 1
    RESPONSE = 2
    ONE_WAY = 3


class RejectionType(IntEnum):
    """(reference: Message.cs RejectionTypes :138)"""

    TRANSIENT = 1
    OVERLOADED = 2
    DUPLICATE_REQUEST = 3
    UNRECOVERABLE = 4
    GATEWAY_TOO_BUSY = 5
    EXPIRED = 6


class ResponseKind(IntEnum):
    SUCCESS = 1
    ERROR = 2
    REJECTION = 3


_message_ids = itertools.count(1)


@dataclass
class Message:
    """The unit of control-plane communication; the header fields of the
    reference's byte-coded header dictionary (Message.cs:39-75) are plain
    fields, and the codec serializes the whole dataclass."""

    category: Category
    direction: Direction
    id: int = field(default_factory=lambda: next(_message_ids))

    sending_silo: Optional[SiloAddress] = None
    sending_grain: Optional[GrainId] = None
    sending_activation: Optional[ActivationId] = None

    target_silo: Optional[SiloAddress] = None
    target_grain: Optional[GrainId] = None
    target_activation: Optional[ActivationId] = None

    interface_id: int = 0
    method_id: int = 0
    method_name: str = ""
    args: Tuple[Any, ...] = ()

    # response fields
    response_kind: ResponseKind = ResponseKind.SUCCESS
    result: Any = None
    rejection_type: Optional[RejectionType] = None
    rejection_info: str = ""

    is_read_only: bool = False
    is_always_interleave: bool = False
    is_new_placement: bool = False
    is_unordered: bool = False

    # hop bookkeeping (reference: ForwardCount, ResendCount)
    forward_count: int = 0
    resend_count: int = 0

    request_context: Optional[Dict[str, Any]] = None
    call_chain: Tuple[GrainId, ...] = ()
    expiration: Optional[float] = None  # absolute time.monotonic() deadline
    cache_invalidation: List[ActivationAddress] = field(default_factory=list)
    timestamps: List[Tuple[str, float]] = field(default_factory=list)

    def is_expired(self) -> bool:
        return self.expiration is not None \
            and time.monotonic() > self.expiration

    def create_response(self, result: Any,
                        kind: ResponseKind = ResponseKind.SUCCESS
                        ) -> "Message":
        """(reference: Message.CreateResponseMessage)"""
        return Message(
            category=self.category,
            direction=Direction.RESPONSE,
            id=self.id,
            sending_silo=self.target_silo,
            sending_grain=self.target_grain,
            sending_activation=self.target_activation,
            target_silo=self.sending_silo,
            target_grain=self.sending_grain,
            target_activation=self.sending_activation,
            interface_id=self.interface_id,
            method_id=self.method_id,
            response_kind=kind,
            result=result,
            request_context=self.request_context,
        )

    def create_rejection(self, rejection: RejectionType,
                         info: str) -> "Message":
        """(reference: Message.CreateRejectionResponse)"""
        msg = self.create_response(None, ResponseKind.REJECTION)
        msg.rejection_type = rejection
        msg.rejection_info = info
        return msg

    def __repr__(self) -> str:
        return (f"Msg(#{self.id} {self.category.name}/{self.direction.name} "
                f"{self.sending_grain}->{self.target_grain} "
                f"m={self.method_name} fwd={self.forward_count})")


# wire registration (reference: Message.cs:518) — the JAX package's name,
# so both packages write the same bytes for one message
_codec.register(Message, name="orleans.Message")


#: the VectorRouter's one-way slab entry point (tensor/router.py)
SLAB_METHOD = "inject_slab"


def is_slab_message(msg: Message) -> bool:
    """True for one-way cross-silo tensor slabs addressed to a peer's
    vector_router system target; a transport bounces these back through
    the router's backoff-reinject path instead of dropping them."""
    return (msg.category == Category.APPLICATION
            and msg.direction == Direction.ONE_WAY
            and msg.method_name == SLAB_METHOD
            and msg.target_grain is not None
            and msg.target_grain.is_system_target
            and msg.target_grain.type_code ==
            int(SystemTargetCodes.VECTOR_ROUTER)
            and len(msg.args) >= 4)


class MessageCenter:
    """Per-silo message hub (reference: MessageCenter.cs:33): local
    targets short-circuit to the dispatcher (MessageCenter.SendMessage
    :184 loopback), remote targets go through the transport."""

    def __init__(self, silo_address: SiloAddress) -> None:
        self.my_address = silo_address
        self.dispatcher = None          # wired by Silo
        self.transport = None           # wired by Silo (InProcTransport)
        self.metrics = None             # wired by Silo (SiloMetrics)

    def send_message(self, msg: Message) -> None:
        if msg.sending_silo is None:
            msg.sending_silo = self.my_address
        if self.metrics is not None:
            self.metrics.messages_sent += 1
        if msg.target_silo is None or msg.target_silo == self.my_address:
            msg.target_silo = self.my_address
            self.deliver_local(msg)
            return
        self.transport.send(msg)

    def deliver_local(self, msg: Message) -> None:
        if self.metrics is not None:
            self.metrics.messages_received += 1
        self.dispatcher.receive_message(msg)
