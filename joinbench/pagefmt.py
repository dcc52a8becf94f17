"""A reader of the 8 KiB page format that ``execute`` returns
its result in, kept apart from the port's codec so that a fault in the
port's page encode cannot be undone by the matching decode.

Fixed-width page (INT32, INT64, FP64): u16 row count, u16 non-null count,
the non-null values packed from byte max(4, width), and at the page's end
the NULL bitmap, (rows + 7) // 8 bytes, bit i (little bit order) set when
row i is non-null.

VARCHAR page: u16 row count, u16 non-null count, then one u16 cumulative
end offset per non-null string, the characters, and the bitmap at the end.
A row count of 0xffff starts a string longer than a page (u16 character
count, characters from byte 4); 0xfffe continues it.

Columns are read in plain PyTorch on the given device (a result of 80 M
rows is read on the card in well under a second; a stream with long-string
pages page by page on the host) into int64 codes and validity, as
:mod:`joinbench.digest` takes them.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import digest

PAGE_SIZE = 8192
LONG_FIRST = 0xFFFF
LONG_CONT = 0xFFFE

_WIDTH = {"INT32": (4, torch.int32), "INT64": (8, torch.int64),
          "FP64": (8, torch.int64)}  # FP64 read as its bits


class PageError(ValueError):
    """The pages do not hold a valid column of the stated row count."""


def _u16(pages, offset: int):
    return pages[:, offset].long() | (pages[:, offset + 1].long() << 8)


def _rows(pages, nr, nv, num_rows: int, device):
    """Each row's page, the validity of every row from the pages' bitmaps,
    and the running count of valid rows; checks the counts."""
    if int(nr.sum()) != num_rows:
        raise PageError(f"pages hold {int(nr.sum())} rows, table says {num_rows}")
    page_of = torch.repeat_interleave(
        torch.arange(pages.shape[0], device=device), nr)
    first = torch.cumsum(nr, 0) - nr
    local = torch.arange(num_rows, device=device) - first[page_of]
    byte = pages.reshape(-1)[page_of * PAGE_SIZE + PAGE_SIZE
                             - ((nr + 7) // 8)[page_of] + local // 8]
    valid = ((byte.long() >> (local % 8)) & 1).bool()
    running = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum(valid.long(), 0)])
    if not torch.equal(running[first + nr] - running[first], nv):
        raise PageError("a page's non-null count disagrees with its bitmap")
    return page_of, valid, running


def read_fixed(pages: np.ndarray, num_rows: int, type_name: str, device):
    """(int64 codes, valid) of a fixed-width column on ``device``; NULL
    rows read 0, FP64 values their bits."""
    width, tdtype = _WIDTH[type_name]
    pages = torch.from_numpy(np.ascontiguousarray(pages)).to(device)
    if pages.shape[0] == 0:
        if num_rows:
            raise PageError(f"no pages for {num_rows} rows")
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z.bool()
    nr, nv = _u16(pages, 0), _u16(pages, 2)
    begin = max(4, width)
    if bool((begin + nv * width + (nr + 7) // 8 > PAGE_SIZE).any()):
        raise PageError("a fixed-width page overflows")
    page_of, valid, running = _rows(pages, nr, nv, num_rows, device)
    rank = running[1:] - 1 - (torch.cumsum(nv, 0) - nv)[page_of]
    words = pages.view(tdtype).reshape(-1)
    per_page = PAGE_SIZE // width
    sel = torch.nonzero(valid).flatten()
    codes = torch.zeros(num_rows, dtype=torch.int64, device=device)
    codes[sel] = words[page_of[sel] * per_page + begin // width
                       + rank[sel]].long()
    return codes, valid


def _read_varchar_pages(pages: np.ndarray):
    """Page by page (a stream with long-string pages)."""
    out, valid = [], []
    for page in pages:
        nr = int(page[0]) | int(page[1]) << 8
        count = int(page[2]) | int(page[3]) << 8
        if nr == LONG_FIRST:
            out.append(page[4:4 + count].tobytes())
            valid.append(True)
            continue
        if nr == LONG_CONT:
            if not out or not valid[-1]:
                raise PageError("a continuation page with no long string")
            out[-1] += page[4:4 + count].tobytes()
            continue
        bits = np.unpackbits(page[PAGE_SIZE - (nr + 7) // 8:], count=nr,
                             bitorder="little").astype(bool)
        if int(bits.sum()) != count:
            raise PageError("a page's non-null count disagrees with its bitmap")
        ends = page[4:4 + 2 * count].view(np.uint16).astype(np.int64)
        raw = page[4 + 2 * count:].tobytes()
        start, k = 0, 0
        for bit in bits:
            if bit:
                out.append(raw[start:ends[k]])
                start = int(ends[k])
                k += 1
            else:
                out.append(b"")
            valid.append(bool(bit))
    return out, valid


def read_varchar(pages: np.ndarray, num_rows: int, device):
    """(int64 codes, valid) of a VARCHAR column on ``device``, the codes of
    :func:`joinbench.digest.string_codes`; NULL rows read 0."""
    if len(pages) == 0:
        if num_rows:
            raise PageError(f"no pages for {num_rows} rows")
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z.bool()
    nr = pages[:, 0].astype(np.int64) | pages[:, 1].astype(np.int64) << 8
    if np.any(nr >= LONG_CONT):
        strings, valid_l = _read_varchar_pages(pages)
        if len(strings) != num_rows:
            raise PageError(f"pages hold {len(strings)} rows, table says "
                            f"{num_rows}")
        lengths = np.fromiter((len(s) for s in strings), np.int64, num_rows)
        heap = torch.from_numpy(np.frombuffer(b"".join(strings), np.uint8).copy())
        valid = torch.from_numpy(np.asarray(valid_l, bool)).to(device)
        return digest.string_codes(heap.to(device),
                                   torch.from_numpy(np.cumsum(lengths)).to(device),
                                   valid), valid
    pages = torch.from_numpy(np.ascontiguousarray(pages)).to(device)
    nr, nv = _u16(pages, 0), _u16(pages, 2)
    _page_of, valid, _running = _rows(pages, nr, nv, num_rows, device)
    flat = pages.reshape(-1)
    # the u16 end offsets of every page's non-null strings, in row order
    page_of_str = torch.repeat_interleave(
        torch.arange(pages.shape[0], device=device), nv)
    k = (torch.arange(int(nv.sum()), device=device)
         - (torch.cumsum(nv, 0) - nv)[page_of_str])
    at = page_of_str * PAGE_SIZE + 4 + 2 * k
    ends_local = flat[at].long() | (flat[at + 1].long() << 8)
    prev = torch.where(k > 0, torch.roll(ends_local, 1),
                       torch.zeros_like(ends_local))
    lengths_str = ends_local - prev
    payload = 4 + 2 * nv
    if bool((lengths_str < 0).any()) or bool(
            (payload[page_of_str] + ends_local + ((nr + 7) // 8)[page_of_str]
             > PAGE_SIZE).any()):
        raise PageError("a VARCHAR page's offsets are out of order or overflow")
    lengths = torch.zeros(num_rows, dtype=torch.int64, device=device)
    lengths[valid] = lengths_str
    starts = torch.zeros(num_rows, dtype=torch.int64, device=device)
    starts[valid] = page_of_str * PAGE_SIZE + payload[page_of_str] + prev
    ends = torch.cumsum(lengths, 0)
    total = int(ends[-1]) if num_rows else 0
    src = (torch.repeat_interleave(starts - (ends - lengths), lengths)
           + torch.arange(total, device=device))
    return digest.string_codes(flat[src], ends, valid), valid


def read_columns(table, device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(codes, valid) of every column of a paged ``ColumnarTable``, on
    ``device``, as :func:`joinbench.digest.digest` takes them."""
    codes, valid = [], []
    for col in table.columns:
        name = col.type.name
        if name == "VARCHAR":
            c, v = read_varchar(col.pages, table.num_rows, device)
        else:
            c, v = read_fixed(col.pages, table.num_rows, name, device)
        codes.append(c)
        valid.append(v)
    return codes, valid

