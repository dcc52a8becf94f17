"""Device-side page decode over row-aligned fixed-geometry pages.

The reference decodes pages on the host and ships dense arrays to the
accelerator (src/build_table.cpp:306-436). On an accelerator that wastes both the
host decode and H2D bytes: this module uploads the RAW 8 KiB pages and
decodes them on the device — headers and NULL bitmaps as plain torch
vector ops, the rank-aligned packed values via one per-page window gather
kernel (ops/kernels.py::paged_window_gather, csrc/paged_window_gather.cu).

The enabling trick is **row alignment**: the page format leaves the page
split free ("any split that decodes to the same rows is valid",
storage/page.py), so :func:`encode_fixed_aligned` packs a FIXED number of
rows per page — every full page has its header, value region, and bitmap
at the same byte offsets. Decode then needs no cross-page scatter or
gather at all:

  * num_values: the constant-offset header word of every page;
  * validity:   the constant-offset bitmap tail, unpacked by a
                broadcast-shift-mask (no gather);
  * values:     packed at position rank = (exclusive cumsum of validity
                within the page); a per-page shared-memory window gather
                realigns them to row order.

Row counts per page are chosen so pages stay standard-decodable
(:mod:`.page` round-trips them bit-exactly), R is a multiple of 128
and R/8 a multiple of 4 (word-aligned bitmap):

  INT32:        R = 1920   (4 + 4R + R/8 = 7924 <= 8192)
  INT64 / FP64: R =  960   (8 + 8R + R/8 = 7808 <= 8192)

A trailing partial page (num_rows % R rows) keeps the standard greedy
layout and is decoded on the host — it is at most one page.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..dtypes import DataType, PAGE_SIZE

#: rows per full aligned page, by dtype
ALIGNED_ROWS = {
    DataType.INT32: 1920,
    DataType.INT64: 960,
    DataType.FP64: 960,
}

_WORDS = PAGE_SIZE // 4  # 2048 i32 words per page


def _value_bytes(dtype: DataType) -> int:
    return 4 if dtype is DataType.INT32 else 8


def encode_fixed_aligned(
    values: np.ndarray, valid: np.ndarray, dtype: DataType
) -> np.ndarray:
    """Dense column -> aligned pages (u8, shape (npages, PAGE_SIZE)).

    Bit-compatible with the standard page format: `page.decode_fixed`
    round-trips the result exactly. Vectorized (no per-row loop)."""
    r = ALIGNED_ROWS[dtype]
    s = _value_bytes(dtype)
    db = max(4, s)
    n = len(valid)
    if n == 0:
        return np.zeros((0, PAGE_SIZE), np.uint8)
    npages = -(-n // r)
    valid_p = np.zeros(npages * r, bool)
    valid_p[:n] = valid
    valid_p = valid_p.reshape(npages, r)
    values_p = np.zeros(npages * r, dtype=values.dtype)
    values_p[:n] = values
    values_p = values_p.reshape(npages, r)

    out = np.zeros((npages, PAGE_SIZE), np.uint8)
    nr = np.full(npages, r, np.uint16)
    nr[-1] = n - (npages - 1) * r
    nv = valid_p.sum(axis=1).astype(np.uint16)
    hdr = out[:, :4].view("<u2")
    hdr[:, 0] = nr
    hdr[:, 1] = nv

    # pack non-null values to the front of each page's value region
    pos = np.cumsum(valid_p, axis=1) - 1  # rank of each valid row
    region = out[:, db:db + s * r].view(f"<{'i' if dtype is not DataType.FP64 else 'f'}{s}")
    region = region.reshape(npages, r)
    pg, rw = np.nonzero(valid_p)
    region[pg, pos[valid_p]] = values_p[pg, rw]

    # bitmap tail: (nr+7)//8 bytes at PAGE_SIZE - size; constant for full
    # pages (R/8), standard variable position for the trailing partial
    bm = np.packbits(valid_p, axis=1, bitorder="little")  # (npages, r//8)
    full = npages - 1 if n % r else npages
    out[:full, PAGE_SIZE - r // 8:] = bm[:full]
    if full < npages:
        bl = (int(nr[-1]) + 7) // 8
        out[-1, PAGE_SIZE - bl:] = bm[-1, :bl]
    return out


def aligned_full_pages(
    pages: np.ndarray, num_rows: int, dtype: DataType
) -> Optional[int]:
    """Number of leading full aligned pages, or None if the page stream
    is not row-aligned for ``dtype`` (e.g. produced by the greedy
    reference-parity encoder). O(npages) header reads."""
    if dtype not in ALIGNED_ROWS or pages.ndim != 2 or not pages.size:
        return None
    r = ALIGNED_ROWS[dtype]
    nr = pages[:, :2].copy().view("<u2")[:, 0].astype(np.int64)
    if int(nr.sum()) != num_rows:
        return None
    full = num_rows // r
    if full > len(pages) or not (nr[:full] == r).all():
        return None
    if len(pages) > full + 1:
        return None  # trailing remainder must be a single page
    return full


def decode_fixed_device(
    pages: np.ndarray, num_rows: int, dtype: DataType, device
):
    """Aligned pages -> (data, valid) tensors on ``device`` of length
    num_rows.

    Uploads the raw page bytes; all decode work happens on the device (the
    trailing partial page, if any, decodes on the host — at most one
    page). FP64 comes back as its int64 bit pattern, matching
    engine.host_column_to_device. Caller must have verified alignment
    via :func:`aligned_full_pages`."""
    from . import page as page_codec
    from ..ops import kernels

    r = ALIGNED_ROWS[dtype]
    s = _value_bytes(dtype)
    full = num_rows // r
    parts_data, parts_valid = [], []
    if full:
        body = torch.from_numpy(
            np.ascontiguousarray(pages[:full]).view("<i4")
        ).to(device)  # (full, 2048) — the raw upload
        # validity: constant-offset bitmap words, broadcast-shift-mask (the
        # arithmetic shift keeps bit 31 correct after the & 1)
        bmw = body[:, _WORDS - r // 32:]  # (full, r/32)
        shifts = torch.arange(32, dtype=torch.int32, device=body.device)
        bits = ((bmw[:, :, None] >> shifts) & 1).reshape(full, r)
        valid = bits.bool()
        # in-page exclusive rank; int32 on purpose (torch's default cumsum
        # of int32 would widen to int64, the kernel takes int32 indices)
        rank = torch.cumsum(bits, dim=1, dtype=torch.int32) - bits
        db_words = max(4, s) // 4  # value region starts at word 1 (i32) / 2 (i64)
        if s == 4:
            vals = kernels.paged_window_gather(body, db_words + rank)
            data = torch.where(valid, vals, 0).reshape(-1)
        else:
            idx = torch.cat(
                [db_words + 2 * rank, db_words + 2 * rank + 1], dim=1
            )
            g = kernels.paged_window_gather(body, idx)
            lo, hi = g[:, :r], g[:, r:]
            v64 = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
            data = torch.where(valid, v64, 0).reshape(-1)
        parts_data.append(data)
        parts_valid.append(valid.reshape(-1))
    rem = num_rows - full * r
    if rem:
        tv, tva = page_codec.decode_fixed(pages[full:], rem, dtype)
        if dtype is DataType.FP64:
            tv = tv.view(np.int64)
        tv = np.where(tva, tv, 0)
        parts_data.append(torch.from_numpy(tv).to(device))
        parts_valid.append(torch.from_numpy(tva).to(device))
    if len(parts_data) == 1:
        return parts_data[0], parts_valid[0]
    return torch.cat(parts_data), torch.cat(parts_valid)


def enabled() -> bool:
    return os.environ.get("RJT_DEVICE_DECODE", "auto") != "off"
