"""Wire serialization: the token-stream binary codec and the copy barrier
(the wire half of ``orleans_tpu/codec.py``).

Parity with the reference's serialization subsystem (reference:
src/Orleans/Serialization/SerializationManager.cs:47 — per-type
registration :328, DeepCopy :850, Serialize :1052, Deserialize :1356;
BinaryTokenStreamWriter.cs:41 / Reader.cs:42; SerializationTokenType.cs:26):

* a token-stream binary format with typed tokens, first-class tokens for
  GrainId / ActivationId / SiloAddress / ActivationAddress (token ids
  40-43, as the reference) and numpy arrays (payload arrays round-trip
  without boxing), the JAX package's format token for token (a type
  without a token — an enum member, a numpy scalar — takes the pickle
  fallback, whose bytes name the package);
* back-references for shared containers; registered dataclasses; the
  pickle fallback;
* ``deep_copy``, the message-passing copy barrier.  Where the JAX package
  passes device arrays through by reference (a JAX array cannot change),
  the port copies a tensor: its owner may rewrite it in place after the
  call;
* ``SlabLeafRef`` / ``flatten_slab_tree`` / ``unflatten_slab_tree``, the
  slab payload's skeleton split, as plain recursive walks over dicts,
  tuples and lists.

A tensor written to the wire crosses as its host array (the NDARRAY
token), so it arrives as numpy, as a slab that crossed to the host does
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import pickle
import struct
import uuid
from enum import IntEnum
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from orleans_tpu_torch.ids import (
    ActivationAddress,
    ActivationId,
    GrainCategory,
    GrainId,
    SiloAddress,
)


class Token(IntEnum):
    """Wire tokens (reference: SerializationTokenType.cs:26)."""

    NONE = 0
    TRUE = 1
    FALSE = 2
    INT = 3            # varint zigzag
    FLOAT = 4          # f64
    STR = 5
    BYTES = 6
    LIST = 7
    TUPLE = 8
    DICT = 9
    SET = 10
    UUID = 11
    FROZENSET = 13
    COMPLEX = 12
    BACKREF = 20       # reference to an earlier object in this stream
    REGISTERED = 30    # type registered with SerializationManager
    FALLBACK = 32      # pickle fallback
    GRAIN_ID = 40
    ACTIVATION_ID = 41
    SILO_ADDRESS = 42
    ACTIVATION_ADDRESS = 43
    NDARRAY = 50       # numpy array payloads


class SerializationError(Exception):
    pass


class Writer:
    """Binary token-stream writer (reference: BinaryTokenStreamWriter.cs)."""

    def __init__(self) -> None:
        self._parts: list = []

    def token(self, t: Token) -> None:
        self._parts.append(bytes((int(t),)))

    def varint(self, v: int) -> None:
        # zigzag + LEB128 — arbitrary-precision ints supported
        z = ((-v) << 1) - 1 if v < 0 else (v << 1)
        out = bytearray()
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self._parts.append(bytes(out))

    def f64(self, v: float) -> None:
        self._parts.append(struct.pack("<d", v))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def raw(self, b: bytes) -> None:
        self.varint(len(b))
        self._parts.append(b)

    def string(self, s: str) -> None:
        self.raw(s.encode("utf-8"))

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    """Binary token-stream reader (reference: BinaryTokenStreamReader.cs)."""

    def __init__(self, data: bytes) -> None:
        self._buf = memoryview(data)
        self._pos = 0

    def token(self) -> Token:
        t = self._buf[self._pos]
        self._pos += 1
        return Token(t)

    def varint(self) -> int:
        shift = 0
        z = 0
        while True:
            b = self._buf[self._pos]
            self._pos += 1
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (z >> 1) if not z & 1 else -((z + 1) >> 1)

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self._buf, self._pos)
        self._pos += 8
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self._buf, self._pos)
        self._pos += 8
        return v

    def raw(self) -> memoryview:
        n = self.varint()
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def string(self) -> str:
        return bytes(self.raw()).decode("utf-8")


_Serializer = Callable[["SerializationManager", Any, Writer, dict], None]
_Deserializer = Callable[["SerializationManager", Reader, dict], Any]
_Copier = Callable[[Any], Any]


class SerializationManager:
    """Type registry + entry points (reference: SerializationManager.cs:47).
    A process-wide instance (``default_manager``) serves the runtime."""

    def __init__(self) -> None:
        self._registered: Dict[str, Tuple[Type, _Serializer, _Deserializer,
                                          Optional[_Copier]]] = {}
        self._by_type: Dict[Type, str] = {}

    def register(self, cls: Type, name: Optional[str] = None,
                 serializer: Optional[_Serializer] = None,
                 deserializer: Optional[_Deserializer] = None,
                 deep_copier: Optional[_Copier] = None) -> None:
        name = name or f"{cls.__module__}.{cls.__qualname__}"
        if serializer is None or deserializer is None:
            if not dataclasses.is_dataclass(cls):
                raise SerializationError(
                    f"register({cls}): non-dataclass types need explicit "
                    f"serializer/deserializer delegates")
            serializer, deserializer = _dataclass_codec(cls)
        self._registered[name] = (cls, serializer, deserializer, deep_copier)
        self._by_type[cls] = name

    # -- serialize ----------------------------------------------------------

    def serialize(self, obj: Any) -> bytes:
        w = Writer()
        self._write(obj, w, {"refs": {}})
        return w.getvalue()

    def deserialize(self, data: bytes) -> Any:
        return self._read(Reader(data), {"refs": {}})

    def _write(self, obj: Any, w: Writer, ctx: dict) -> None:
        if obj is None:
            w.token(Token.NONE)
            return
        if obj is True:
            w.token(Token.TRUE)
            return
        if obj is False:
            w.token(Token.FALSE)
            return
        t = type(obj)
        if t is int:
            w.token(Token.INT)
            w.varint(obj)
            return
        if t is float:
            w.token(Token.FLOAT)
            w.f64(obj)
            return
        if t is str:
            w.token(Token.STR)
            w.string(obj)
            return
        if t is bytes or t is bytearray:
            w.token(Token.BYTES)
            w.raw(bytes(obj))
            return
        if t is complex:
            w.token(Token.COMPLEX)
            w.f64(obj.real)
            w.f64(obj.imag)
            return
        if t is uuid.UUID:
            w.token(Token.UUID)
            w.u64((obj.int >> 64) & 0xFFFFFFFFFFFFFFFF)
            w.u64(obj.int & 0xFFFFFFFFFFFFFFFF)
            return
        if t is GrainId:
            w.token(Token.GRAIN_ID)
            w.varint(obj.type_code)
            w.u64(obj.n0)
            w.u64(obj.n1)
            w.varint(int(obj.category))
            if obj.key_ext is not None:
                w.token(Token.TRUE)
                w.string(obj.key_ext)
            else:
                w.token(Token.FALSE)
            return
        if t is ActivationId:
            w.token(Token.ACTIVATION_ID)
            w.u64(obj.n0)
            w.u64(obj.n1)
            return
        if t is SiloAddress:
            w.token(Token.SILO_ADDRESS)
            w.string(obj.host)
            w.varint(obj.port)
            w.varint(obj.generation)
            return
        if t is ActivationAddress:
            w.token(Token.ACTIVATION_ADDRESS)
            self._write(obj.silo, w, ctx)
            self._write(obj.grain, w, ctx)
            self._write(obj.activation, w, ctx)
            return
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        if isinstance(obj, np.ndarray):
            if obj.dtype.hasobject:
                # tobytes() of an object array would write heap pointers
                raise TypeError(
                    "object-dtype ndarrays are not wire-serializable "
                    f"(dtype {obj.dtype!r}); convert to a numeric dtype "
                    "or a list")
            w.token(Token.NDARRAY)
            w.string(str(obj.dtype))
            w.varint(obj.ndim)
            for d in obj.shape:
                w.varint(d)
            w.raw(np.ascontiguousarray(obj).tobytes())
            return

        # mutable containers & objects: back-reference tracking
        oid = id(obj)
        refs = ctx["refs"]
        if oid in refs:
            w.token(Token.BACKREF)
            w.varint(refs[oid])
            return
        if t is list:
            refs[oid] = len(refs)
            w.token(Token.LIST)
            w.varint(len(obj))
            for item in obj:
                self._write(item, w, ctx)
            return
        if t is tuple:
            w.token(Token.TUPLE)
            w.varint(len(obj))
            for item in obj:
                self._write(item, w, ctx)
            return
        if t is dict:
            refs[oid] = len(refs)
            w.token(Token.DICT)
            w.varint(len(obj))
            for k, v in obj.items():
                self._write(k, w, ctx)
                self._write(v, w, ctx)
            return
        if t is set or t is frozenset:
            if t is set:
                refs[oid] = len(refs)
            w.token(Token.SET if t is set else Token.FROZENSET)
            w.varint(len(obj))
            for item in obj:
                self._write(item, w, ctx)
            return
        name = self._by_type.get(t)
        if name is not None:
            refs[oid] = len(refs)
            _, ser, _, _ = self._registered[name]
            w.token(Token.REGISTERED)
            w.string(name)
            ser(self, obj, w, ctx)
            return
        # pickle fallback (reference: BinaryFormatter fallback path)
        refs[oid] = len(refs)
        w.token(Token.FALLBACK)
        w.raw(pickle.dumps(obj))

    def _read(self, r: Reader, ctx: dict) -> Any:
        refs = ctx["refs"]
        t = r.token()
        if t == Token.NONE:
            return None
        if t == Token.TRUE:
            return True
        if t == Token.FALSE:
            return False
        if t == Token.INT:
            return r.varint()
        if t == Token.FLOAT:
            return r.f64()
        if t == Token.STR:
            return r.string()
        if t == Token.BYTES:
            return bytes(r.raw())
        if t == Token.COMPLEX:
            return complex(r.f64(), r.f64())
        if t == Token.UUID:
            hi = r.u64()
            return uuid.UUID(int=(hi << 64) | r.u64())
        if t == Token.GRAIN_ID:
            type_code = r.varint()
            n0 = r.u64()
            n1 = r.u64()
            cat = GrainCategory(r.varint())
            ext = r.string() if r.token() == Token.TRUE else None
            return GrainId._intern(GrainId(type_code, n0, n1, cat, ext))
        if t == Token.ACTIVATION_ID:
            return ActivationId(r.u64(), r.u64())
        if t == Token.SILO_ADDRESS:
            return SiloAddress(r.string(), r.varint(), r.varint())
        if t == Token.ACTIVATION_ADDRESS:
            silo = self._read(r, ctx)
            grain = self._read(r, ctx)
            return ActivationAddress(silo, grain, self._read(r, ctx))
        if t == Token.NDARRAY:
            dtype = np.dtype(r.string())
            if dtype.hasobject:
                raise ValueError(f"refusing object ndarray dtype {dtype!r}")
            ndim = r.varint()
            shape = tuple(r.varint() for _ in range(ndim))
            return np.frombuffer(bytes(r.raw()), dtype=dtype).reshape(
                shape).copy()
        if t == Token.BACKREF:
            return refs[r.varint()]
        if t == Token.LIST:
            out: list = []
            refs[len(refs)] = out
            for _ in range(r.varint()):
                out.append(self._read(r, ctx))
            return out
        if t == Token.TUPLE:
            n = r.varint()
            return tuple(self._read(r, ctx) for _ in range(n))
        if t == Token.DICT:
            d: dict = {}
            refs[len(refs)] = d
            for _ in range(r.varint()):
                k = self._read(r, ctx)
                d[k] = self._read(r, ctx)
            return d
        if t == Token.SET:
            slot = len(refs)
            refs[slot] = None
            n = r.varint()
            s = {self._read(r, ctx) for _ in range(n)}
            refs[slot] = s
            return s
        if t == Token.FROZENSET:
            n = r.varint()
            return frozenset(self._read(r, ctx) for _ in range(n))
        if t == Token.REGISTERED:
            name = r.string()
            entry = self._registered.get(name)
            if entry is None:
                raise SerializationError(f"unknown registered type {name!r}")
            slot = len(refs)
            refs[slot] = None
            # two-phase deserializers register the shell first, so cyclic
            # graphs resolve back-references to the real object
            ctx["register_ref"] = lambda obj: refs.__setitem__(slot, obj)
            obj = entry[2](self, r, ctx)
            ctx.pop("register_ref", None)
            refs[slot] = obj
            return obj
        if t == Token.FALLBACK:
            slot = len(refs)
            refs[slot] = None
            obj = pickle.loads(bytes(r.raw()))
            refs[slot] = obj
            return obj
        raise SerializationError(f"unexpected token {t}")

    # -- deep copy (reference: SerializationManager.DeepCopy :850) ----------

    _SHALLOW_SAFE = (int, float, str, bytes, bool, type(None), complex,
                     uuid.UUID, GrainId, ActivationId, SiloAddress,
                     ActivationAddress, frozenset, np.generic)

    def deep_copy(self, obj: Any, _memo: Optional[dict] = None) -> Any:
        """Copy barrier for in-process message passing.  A tensor is
        cloned on its stream."""
        if isinstance(obj, self._SHALLOW_SAFE):
            return obj
        memo = _memo if _memo is not None else {}
        oid = id(obj)
        if oid in memo:
            return memo[oid]
        t = type(obj)
        if isinstance(obj, (np.ndarray, torch.Tensor)):
            c = obj.clone() if isinstance(obj, torch.Tensor) else obj.copy()
        elif t is list:
            c = []
            memo[oid] = c
            c.extend(self.deep_copy(x, memo) for x in obj)
        elif t is tuple:
            return tuple(self.deep_copy(x, memo) for x in obj)
        elif t is dict:
            c = {}
            memo[oid] = c
            for k, v in obj.items():
                c[self.deep_copy(k, memo)] = self.deep_copy(v, memo)
        elif t is set:
            c = {self.deep_copy(x, memo) for x in obj}
        else:
            name = self._by_type.get(t)
            copier = self._registered[name][3] if name is not None else None
            # round-trip through the codec (correct for cycles via refs)
            c = copier(obj) if copier is not None \
                else self.deserialize(self.serialize(obj))
        memo[oid] = c
        return c


def _dataclass_codec(cls: Type) -> Tuple[_Serializer, _Deserializer]:
    dc_fields = dataclasses.fields(cls)
    fields = [f.name for f in dc_fields]

    def ser(mgr: SerializationManager, obj: Any, w: Writer, ctx: dict) -> None:
        # field-count prefix: records written before a field was appended
        # still read, missing trailing fields take their defaults
        w.varint(len(fields))
        for fname in fields:
            mgr._write(getattr(obj, fname), w, ctx)

    def deser(mgr: SerializationManager, r: Reader, ctx: dict) -> Any:
        obj = object.__new__(cls)
        register = ctx.pop("register_ref", None)
        if register is not None:
            register(obj)
        stored = r.varint()
        for fname in fields[:stored]:
            object.__setattr__(obj, fname, mgr._read(r, ctx))
        for _ in range(max(0, stored - len(fields))):
            mgr._read(r, ctx)  # a field this version does not know
        for f in dc_fields[stored:]:
            if f.default is not dataclasses.MISSING:
                object.__setattr__(obj, f.name, f.default)
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                object.__setattr__(obj, f.name, f.default_factory())
            else:
                raise SerializationError(
                    f"{cls.__name__}.{f.name} missing from stored record "
                    "and has no default")
        return obj

    return ser, deser


# Process-wide default (reference: SerializationManager static surface).
default_manager = SerializationManager()


@dataclasses.dataclass(frozen=True)
class SlabLeafRef:
    """Skeleton placeholder for the ``index``-th raw array buffer of a slab
    frame; scalar/non-array leaves stay inline in the skeleton."""

    index: int


def flatten_slab_tree(args: Any) -> Tuple[Any, list]:
    """Split a slab arg tree into ``(skeleton, arrays)``: array-like
    leaves (tensors as their host arrays) become :class:`SlabLeafRef`
    placeholders; plain scalars and strings stay inline."""
    arrays: list = []

    def walk(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, (bool, int, float, str, bytes, type(None))):
            return x
        a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        if a.dtype.hasobject:
            raise TypeError(
                "object-dtype ndarrays are not wire-serializable "
                f"(dtype {a.dtype!r}); convert to a numeric dtype or a list")
        arrays.append(a)
        return SlabLeafRef(len(arrays) - 1)

    return walk(args), arrays


def unflatten_slab_tree(skeleton: Any, arrays: list) -> Any:
    """Inverse of :func:`flatten_slab_tree` given the decoded buffers."""
    if isinstance(skeleton, SlabLeafRef):
        return arrays[skeleton.index]
    if isinstance(skeleton, dict):
        return {k: unflatten_slab_tree(v, arrays)
                for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(unflatten_slab_tree(v, arrays)
                              for v in skeleton)
    return skeleton
