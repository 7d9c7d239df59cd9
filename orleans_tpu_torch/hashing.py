"""Stable hashing for identity (copy of ``orleans_tpu/hashing.py``'s
``jenkins_hash`` and ``stable_hash_u64``).

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
