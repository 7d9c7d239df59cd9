"""Identity primitives (the part of ``orleans_tpu/ids.py`` the port needs):
type codes, grain identities, silo addresses and the well-known
system-target codes.

A grain identity is a 128-bit key (two 64-bit words) + a type code + an
optional string extension, tagged with a category (reference:
src/Orleans/IDs/GrainId.cs:33, UniqueKey.cs:34).  ``ring_hash`` is the
32-bit uniform hash the consistent ring places grains by, the same
number ``hashing.ring_hash_int_keys`` computes for a vector of integer
keys, so the per-message and the batched ownership lookups agree.
``SiloAddress`` is endpoint + generation, so a restarted silo on the same
port is a different silo (reference: SiloAddress.cs).
"""

from __future__ import annotations

import itertools
import struct
import threading
import uuid
import weakref
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from orleans_tpu_torch.hashing import jenkins_hash


def type_code_of(type_name: str) -> int:
    """Stable 31-bit type code for a grain interface/class name.

    Reference analog: GrainInterfaceData.GetGrainInterfaceId — codegen'd
    integer ids; here derived by stable hash of the name (no codegen step).
    """
    return jenkins_hash(type_name.encode("utf-8")) & 0x7FFFFFFF


class GrainCategory(IntEnum):
    """Key category (reference: UniqueKey.cs Category enum)."""

    GRAIN = 1
    CLIENT = 2
    SYSTEM_TARGET = 3
    SYSTEM_GRAIN = 4
    KEY_EXT_GRAIN = 5


_intern_lock = threading.Lock()
_grain_id_intern: "weakref.WeakValueDictionary[tuple, GrainId]" = \
    weakref.WeakValueDictionary()


@dataclass(frozen=True, eq=False)
class GrainId:
    """Logical grain identity (reference: GrainId.cs:33 over
    UniqueKey.cs:34): ``n0``/``n1`` are the two 64-bit words of the
    primary key; string keys ride in ``key_ext``."""

    type_code: int
    n0: int
    n1: int
    category: GrainCategory = GrainCategory.GRAIN
    key_ext: Optional[str] = None

    @staticmethod
    def _intern(gid: "GrainId") -> "GrainId":
        key = (gid.type_code, gid.n0, gid.n1, int(gid.category), gid.key_ext)
        with _intern_lock:
            existing = _grain_id_intern.get(key)
            if existing is not None:
                return existing
            _grain_id_intern[key] = gid
            return gid

    @classmethod
    def from_int(cls, type_code: int, key: int,
                 category: GrainCategory = GrainCategory.GRAIN) -> "GrainId":
        """Integer-keyed grain (reference: GrainFactory.GetGrain<T>(long))."""
        return cls._intern(cls(type_code, 0, key & 0xFFFFFFFFFFFFFFFF,
                               category))

    @classmethod
    def from_guid(cls, type_code: int, key: uuid.UUID,
                  category: GrainCategory = GrainCategory.GRAIN) -> "GrainId":
        n = key.int
        return cls._intern(cls(type_code, (n >> 64) & 0xFFFFFFFFFFFFFFFF,
                               n & 0xFFFFFFFFFFFFFFFF, category))

    @classmethod
    def system_target(cls, type_code: int) -> "GrainId":
        """Well-known runtime actor id (reference: Constants.cs:52-61)."""
        return cls._intern(cls(type_code, 0, 0, GrainCategory.SYSTEM_TARGET))

    @classmethod
    def client(cls, client_uuid: uuid.UUID) -> "GrainId":
        return cls.from_guid(0, client_uuid, GrainCategory.CLIENT)

    @property
    def primary_key_int(self) -> int:
        return self.n1

    @property
    def is_client(self) -> bool:
        return self.category == GrainCategory.CLIENT

    @property
    def is_system_target(self) -> bool:
        return self.category == GrainCategory.SYSTEM_TARGET

    def ring_hash(self) -> int:
        """32-bit uniform hash for consistent-ring placement
        (reference: GrainId.GetUniformHashCode → JenkinsHash over key
        bytes)."""
        buf = struct.pack("<QQI", self.n0, self.n1,
                          (self.type_code & 0xFFFFFFFF)
                          | (int(self.category) << 29) & 0xFFFFFFFF)
        if self.key_ext is not None:
            buf += self.key_ext.encode("utf-8")
        return jenkins_hash(buf)

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.type_code, self.n0, self.n1,
                      int(self.category), self.key_ext))
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, GrainId):
            return NotImplemented
        return (self.type_code == other.type_code and self.n0 == other.n0
                and self.n1 == other.n1 and self.category == other.category
                and self.key_ext == other.key_ext)

    def __repr__(self) -> str:
        key = repr(self.key_ext) if self.key_ext is not None else (
            str(self.n1) if self.n0 == 0
            else str(uuid.UUID(int=(self.n0 << 64) | self.n1)))
        return f"GrainId({self.category.name.lower()}:{self.type_code:x}/{key})"


@dataclass(frozen=True)
class SiloAddress:
    """Silo endpoint + generation (reference: SiloAddress.cs).  The
    generation comes from a process-wide counter, so silos of one process
    never share an identity."""

    host: str
    port: int
    generation: int

    _counter = itertools.count(1)

    @classmethod
    def new_local(cls, host: str = "local", port: int = 0) -> "SiloAddress":
        return cls(host, port, next(cls._counter))

    def ring_hash(self) -> int:
        """Uniform hash for the silo's point on the consistent ring
        (reference: SiloAddress.GetConsistentHashCode)."""
        return jenkins_hash(
            f"{self.host}:{self.port}@{self.generation}".encode("utf-8"))

    def matches(self, other: "SiloAddress") -> bool:
        """Same endpoint, ignoring generation (reference:
        SiloAddress.Matches)."""
        return self.host == other.host and self.port == other.port

    def __str__(self) -> str:
        return f"S{self.host}:{self.port}:{self.generation}"


@dataclass(frozen=True)
class ActivationId:
    """Physical activation instance id (reference: ActivationId.cs)."""

    n0: int
    n1: int


@dataclass(frozen=True)
class ActivationAddress:
    """Full routing address: (silo, grain, activation)
    (reference: ActivationAddress.cs)."""

    silo: SiloAddress
    grain: GrainId
    activation: ActivationId


class SystemTargetCodes(IntEnum):
    """Well-known system-target type codes (reference: Constants.cs:52-61)."""

    DIRECTORY_SERVICE = 10
    SILO_CONTROL = 12
    CLIENT_OBSERVER_REGISTRAR = 13
    CATALOG = 14
    MEMBERSHIP_ORACLE = 15
    REMINDER_SERVICE = 16
    TYPE_MANAGER = 17
    PROVIDER_MANAGER = 19
    DEPLOYMENT_LOAD_PUBLISHER = 22
    STREAM_PULLING_MANAGER = 23
    VECTOR_ROUTER = 24
