"""An order-free digest of a row multiset, the same arithmetic for the
program's result and the plain reference's.

Every column becomes one int64 code a row: an integer its value, a FP64
its bits, a VARCHAR a 62-bit polynomial hash of its bytes and length; a
NULL row reads code 0 with its validity mixed in apart. Each row's codes
are folded into a number below the prime p = 2^31 - 1 by a keyed map that
is not linear in the columns (squares of sums), so that values moved
between rows or columns change it; the digest is the row count and the
sums, mod p, of three such maps under independent keys. Equal multisets
give equal digests; a row dropped, added or changed changes it except with
a chance near 2^-93. Everything is int64 arithmetic whose products stay
below 2^62, in plain PyTorch, on any device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

P = (1 << 31) - 1
_P2 = (1 << 31) - 19  # the second modulus of the string hash
_MASK21 = (1 << 21) - 1
_MASK22 = (1 << 22) - 1
_KEYS = np.random.default_rng(20250517).integers(1, P, size=(3, 16, 8))


def string_codes(heap: torch.Tensor, ends: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """int64 codes of VARCHAR values given as a uint8 byte heap and int64
    cumulative end offsets (tensors on one device): two polynomial hashes
    of the bytes, mod two primes below 2^31, and the length, folded into
    one int64; 0 for a NULL row."""
    device = heap.device
    n = int(valid.shape[0])
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    ends = ends.long()
    lengths = torch.diff(ends, prepend=torch.zeros(1, dtype=torch.int64,
                                                   device=device))
    starts = ends - lengths
    total = int(ends[-1])
    longest = int(lengths.max())
    owner = torch.repeat_interleave(torch.arange(n, device=device), lengths)
    rel = torch.arange(total, device=device) - starts[owner]
    byte = heap[:total].long() + 1
    out = []
    for mod, base in ((P, 131), (_P2, 257)):
        powers = np.ones(max(longest, 1), np.int64)
        for i in range(1, longest):
            powers[i] = powers[i - 1] * base % mod
        terms = byte * torch.from_numpy(powers).to(device)[rel] % mod
        # a prefix sum of terms below 2^31 stays exact for heaps below 4 GB
        running = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                             torch.cumsum(terms, 0)])
        out.append((running[ends] - running[starts]) % mod)
    codes = (out[0] << 31) ^ out[1] ^ (lengths << 48)
    return torch.where(valid, codes, torch.zeros_like(codes))


def _fold(codes: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
          keys: np.ndarray) -> torch.Tensor:
    """One keyed map of every row into [0, p)."""
    h = None
    for j, (c, v) in enumerate(zip(codes, valid)):
        k = [int(x) for x in keys[j % len(keys)]]
        c = torch.where(v, c, torch.zeros_like(c))
        lo, mid, hi = c & _MASK21, (c >> 21) & _MASK21, (c >> 42) & _MASK22
        x = (lo * k[0] + mid * k[1] + hi * k[2] + v.long() * k[3] + k[4]) % P
        x = (x * x % P + x * k[5] + j * k[6] + k[7]) % P
        h = x if h is None else ((h * k[1] % P + x) % P)
        h = (h * h % P + h * k[2] + k[3]) % P
    return h


def digest(codes: List[torch.Tensor], valid: List[torch.Tensor],
           block: int = 1 << 24) -> Tuple[int, int, int, int]:
    """(rows, s0, s1, s2) of the rows given as per-column int64 codes and
    bool validity, all of one length, on one device; in blocks of
    ``block`` rows."""
    n = int(codes[0].shape[0]) if codes else 0
    sums = [0, 0, 0]
    for start in range(0, n, block):
        cs = [c[start:start + block] for c in codes]
        vs = [v[start:start + block] for v in valid]
        for i in range(3):
            sums[i] = (sums[i] + int(_fold(cs, vs, _KEYS[i]).sum()) % P) % P
    return (n, *sums)
