"""Key hashing for radix partitioning (port of radixjoin_tpu/ops/hashing.py).

A Murmur3 64-bit finalizer for integer keys and FNV-1a for byte strings,
the family of the reference's hash (src/execute.cpp:16-41). Hashes never
leave the engine; what matters is that the host twin and the tensor
version agree bit for bit, because host partitioning and device
partitioning must put a key into the same bucket.

PyTorch has no usable ``uint64`` arithmetic, so :func:`murmur64` computes
in ``int64``: multiplies wrap, the two constants are written as their
two's-complement ``int64`` values, and the logical ``>> 33`` is an
arithmetic shift with the 31 kept bits masked. Its result is the uint64
hash's bit pattern as ``int64`` (``murmur64_np(k).view(np.int64)``).
:func:`umod` and :func:`udiv` take ``%`` and ``//`` of such a pattern as
the unsigned number it stands for (torch's ``%`` and ``//`` are signed).
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0xFF51AFD7ED558CCD - (1 << 64)
_C2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_MASK31 = (1 << 31) - 1


def _lsr33(k: torch.Tensor) -> torch.Tensor:
    """Logical ``k >> 33`` on int64 bit patterns."""
    return (k >> 33) & _MASK31


def murmur64(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer over integer keys -> int64 bit patterns of the
    uint64 hashes. Narrower keys sign-extend, as ``astype(uint64)`` does."""
    k = keys.to(torch.int64)
    k = k ^ _lsr33(k)
    k = k * _C1
    k = k ^ _lsr33(k)
    k = k * _C2
    k = k ^ _lsr33(k)
    return k


def _udivmod(h: torch.Tensor, n: int):
    """Unsigned ``divmod`` of int64 bit patterns by ``1 <= n < 2^31``: long
    division over the two 32-bit halves, every step exact in int64."""
    if not 1 <= n < (1 << 31):
        raise ValueError(f"divisor {n} outside [1, 2^31)")
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    q_hi, r_hi = hi // n, hi % n
    rest = (r_hi << 32) | lo  # < n * 2^32 <= 2^63
    return (q_hi << 32) | (rest // n), rest % n


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h % n`` for the uint64 numbers whose bit patterns ``h`` holds
    (int64 in, int64 out, in ``[0, n)``)."""
    return _udivmod(h, n)[1]


def udiv(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h // n`` for the uint64 numbers whose bit patterns ``h`` holds,
    returned as uint64 bit patterns in int64."""
    return _udivmod(h, n)[0]


def murmur64_np(keys: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`murmur64` for host-side partitioning (uint64)."""
    with np.errstate(over="ignore"):
        k = keys.astype(np.uint64)
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xFF51AFD7ED558CCD)
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xC4CEB9FE1A85EC53)
        k ^= k >> np.uint64(33)
    return k


def fnv1a64_np(values: np.ndarray) -> np.ndarray:
    """FNV-1a over an object array of ``bytes`` -> uint64 (host side).
    Strings are dictionary-encoded before they reach the device, so string
    hashing only happens on the host."""
    out = np.empty(len(values), dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    basis = np.uint64(0xCBF29CE484222325)
    with np.errstate(over="ignore"):
        for i, v in enumerate(values):
            h = basis
            for b in v:
                h ^= np.uint64(b)
                h *= prime
            out[i] = h
    return out


def fnv1a64(ids: torch.Tensor) -> torch.Tensor:
    """Device-side stand-in: dictionary ids are ints; mix them like ints."""
    return murmur64(ids)
