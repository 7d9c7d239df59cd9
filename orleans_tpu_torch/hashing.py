"""Stable hashing for identity (copy of ``orleans_tpu/hashing.py``'s
``jenkins_hash``, ``stable_hash_u64`` and ``ring_hash_int_keys``).

The reference hashes grain identities with Bob Jenkins' lookup2 (reference:
src/Orleans/IDs/JenkinsHash.cs) so type codes and placement are stable
across processes and runtimes; the port must produce the same numbers as
the JAX package, so this is a verbatim copy of its pure-Python integer
math.
"""

from __future__ import annotations

import struct

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    # Jenkins lookup2 mix, 32-bit modular arithmetic.
    a = (a - b - c) & _MASK32
    a ^= c >> 13
    b = (b - c - a) & _MASK32
    b ^= (a << 8) & _MASK32
    c = (c - a - b) & _MASK32
    c ^= b >> 13
    a = (a - b - c) & _MASK32
    a ^= c >> 12
    b = (b - c - a) & _MASK32
    b ^= (a << 16) & _MASK32
    c = (c - a - b) & _MASK32
    c ^= b >> 5
    a = (a - b - c) & _MASK32
    a ^= c >> 3
    b = (b - c - a) & _MASK32
    b ^= (a << 10) & _MASK32
    c = (c - a - b) & _MASK32
    c ^= b >> 15
    return a, b, c


def jenkins_hash(data: bytes) -> int:
    """32-bit Jenkins lookup2 hash of ``data`` (stable across processes)."""
    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    i = 0
    while length - i >= 12:
        ka, kb, kc = struct.unpack_from("<III", data, i)
        a = (a + ka) & _MASK32
        b = (b + kb) & _MASK32
        c = (c + kc) & _MASK32
        a, b, c = _mix(a, b, c)
        i += 12
    c = (c + length) & _MASK32
    tail = data[i:]
    a_add = b_add = c_add = 0
    for idx, byte in enumerate(tail):
        if idx < 4:
            a_add |= byte << (8 * idx)
        elif idx < 8:
            b_add |= byte << (8 * (idx - 4))
        else:
            # c's low byte holds the length, so the tail fills bytes 1..3.
            c_add |= byte << (8 * (idx - 8 + 1))
    a = (a + a_add) & _MASK32
    b = (b + b_add) & _MASK32
    c = (c + c_add) & _MASK32
    a, b, c = _mix(a, b, c)
    return c


def stable_hash_u64(x: int) -> int:
    """64-bit splitmix64 finalizer — stable scalar hash for packed ids."""
    x &= _MASK64
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def ring_hash_int_keys(type_code: int, keys, category: int = 1):
    """Vectorized ``GrainId.from_int(type_code, key).ring_hash()`` (a copy
    of ``orleans_tpu/hashing.py``'s ``ring_hash_int_keys``).

    Bit-exact numpy replay of ``jenkins_hash`` over the 20-byte
    ``pack("<QQI", 0, key, word)`` buffer an int-keyed GrainId hashes
    (``ids.GrainId.ring_hash``), so batched ownership partitioning (the
    cross-silo vector data plane) and per-message placement agree on one
    owner per key.  Returns uint32[n] ring points.
    """
    import numpy as np

    m32 = np.uint64(0xFFFFFFFF)
    keys = np.asarray(keys).astype(np.uint64)

    def mix(a, b, c):
        # Jenkins lookup2 mix in uint64 lanes masked to 32 bits
        for sa, sb, sc in ((13, 8, 13), (12, 16, 5), (3, 10, 15)):
            a = (a - b - c) & m32
            a ^= c >> np.uint64(sa)
            b = (b - c - a) & m32
            b ^= (a << np.uint64(sb)) & m32
            c = (c - a - b) & m32
            c ^= b >> np.uint64(sc)
        return a, b, c

    init = np.uint64(0x9E3779B9)
    # block 1 (bytes 0-11): n0 low, n0 high (both 0), n1 low = key_lo
    a = np.full(keys.shape, init, dtype=np.uint64)
    b = np.full(keys.shape, init, dtype=np.uint64)
    c = keys & m32
    a, b, c = mix(a, b, c)
    # tail (8 of 20 bytes): c += length, a += key_hi, b += word
    word = (type_code & 0xFFFFFFFF) | ((category << 29) & 0xFFFFFFFF)
    c = (c + np.uint64(20)) & m32
    a = (a + (keys >> np.uint64(32))) & m32
    b = (b + np.uint64(word)) & m32
    a, b, c = mix(a, b, c)
    return c.astype(np.uint32)
