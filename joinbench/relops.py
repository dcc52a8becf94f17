"""Plain relational operators of the references: selections in NumPy over
the generated columns (equality, IN, BETWEEN, comparisons and LIKE with
SQL's NULL rule: a comparison with NULL is not true) and inner equi-joins
in plain PyTorch (sort, binary search, expansion), where a NULL key joins
nothing. They import nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import digest, schema


class Table:
    """A generated table's columns by name (the ``HostTable`` the program
    is handed, read only)."""

    def __init__(self, name: str, host):
        self.name = name
        self.host = host
        self.index = {c: i for i, (c, _dt) in enumerate(schema.ATTRIBUTES[name])}

    def col(self, column: str):
        return self.host.columns[self.index[column]]

    @property
    def num_rows(self) -> int:
        return self.host.num_rows


# -- selections (NumPy, one bool per row) --------------------------------------


def _varchar(col):
    ends = np.asarray(col.ends, np.int64)
    return np.asarray(col.heap, np.uint8), ends, ends - np.diff(ends, prepend=0)


def _prefix_equal(heap, starts, lengths, valid, lit: bytes) -> np.ndarray:
    ok = valid & (lengths >= len(lit))
    for k, ch in enumerate(lit):
        pos = np.minimum(starts + k, max(len(heap) - 1, 0))
        ok &= (heap[pos] == ch) if len(heap) else False
    return ok


def eq(col, value) -> np.ndarray:
    if isinstance(value, bytes):
        heap, ends, starts = _varchar(col)
        lengths = ends - starts
        return _prefix_equal(heap, starts, lengths, col.valid & (lengths == len(value)),
                             value)
    return col.valid & (col.values == value)


def isin(col, values: Sequence) -> np.ndarray:
    out = np.zeros(len(col.valid), bool)
    for v in values:
        out |= eq(col, v)
    return out


def compare(col, op: str, value) -> np.ndarray:
    v = col.values
    res = {"<": v < value, "<=": v <= value, ">": v > value,
           ">=": v >= value}[op]
    return col.valid & res


def between(col, lo, hi) -> np.ndarray:
    return col.valid & (col.values >= lo) & (col.values <= hi)


def _occurrences(heap: np.ndarray, lit: bytes) -> np.ndarray:
    """Sorted heap positions where ``lit`` starts."""
    m = len(lit)
    if m > len(heap):
        return np.zeros(0, np.int64)
    cand = np.flatnonzero(heap[:len(heap) - m + 1] == lit[0])
    for k in range(1, m):
        cand = cand[heap[cand + k] == lit[k]]
    return cand.astype(np.int64)


def like(col, pattern: bytes) -> np.ndarray:
    """``col LIKE pattern`` for patterns of literal runs and ``%``: the
    runs matched leftmost first, in order, the first and last anchored
    where the pattern does not start or end with ``%``."""
    if b"_" in pattern:
        raise ValueError("LIKE with '_' is not supported")
    heap, ends, starts = _varchar(col)
    lengths = ends - starts
    runs = pattern.split(b"%")
    if len(runs) == 1:
        return eq(col, pattern)
    ok = col.valid.copy()
    head, middle, tail = runs[0], runs[1:-1], runs[-1]
    ok &= _prefix_equal(heap, starts, lengths, ok, head)
    cursor = starts + len(head)
    for run in middle:
        if not run:
            continue
        occ = _occurrences(heap, run)
        i = np.searchsorted(occ, cursor)
        found = i < len(occ)
        at = occ[np.minimum(i, max(len(occ) - 1, 0))] if len(occ) else cursor
        ok &= found & (at + len(run) <= ends)
        cursor = np.where(ok, at + len(run), cursor)
    if tail:
        tail_start = ends - len(tail)
        ok &= (tail_start >= cursor) & _prefix_equal(
            heap, tail_start, lengths - (tail_start - starts), ok, tail)
    return ok


# -- relations on the device (plain PyTorch) -------------------------------------


class Rel:
    """Columns of one relation on ``device``, keyed ``alias.column``:
    ``(int64 codes, bool valid)``, all of one length. A VARCHAR column
    also carries its rows in the generated table (key ``alias.column#row``),
    so that :meth:`values` can give its strings back."""

    def __init__(self, cols, sources):
        self.cols = cols
        self.sources = sources  # alias.column -> the generated column

    def __len__(self) -> int:
        return int(next(iter(self.cols.values()))[0].shape[0])

    def take(self, idx: torch.Tensor) -> "Rel":
        return Rel({k: (c[idx], v[idx]) for k, (c, v) in self.cols.items()},
                   self.sources)

    def out(self, names: List[str]):
        """(codes, valid) lists of the named columns, for the digest."""
        return ([self.cols[n][0] for n in names],
                [self.cols[n][1] for n in names])

    def values(self, names: List[str]):
        """The named columns as ``(type name, values or (heap, ends),
        valid)`` in NumPy, for writing them as pages."""
        out = []
        for n in names:
            col = self.sources[n]
            codes, valid = (x.cpu().numpy() for x in self.cols[n])
            if col.dtype.name != "VARCHAR":
                out.append((col.dtype.name, codes, valid))
                continue
            rows = self.cols[n + "#row"][0].cpu().numpy()
            heap, ends, starts = _varchar(col)
            lengths = np.where(valid, (ends - starts)[rows], 0)
            out.append(("VARCHAR",
                        schema.gather_varlen(heap, starts[rows], lengths),
                        valid))
        return out


def scan(table: Table, alias: str, columns: Sequence[str], mask, device) -> Rel:
    """The rows of ``table`` where ``mask`` holds (all when None), the
    named columns as codes on ``device``."""
    rows = (np.arange(table.num_rows) if mask is None
            else np.flatnonzero(mask))
    cols, sources = {}, {}
    for c in columns:
        col = table.col(c)
        key = f"{alias}.{c}"
        sources[key] = col
        valid = col.valid[rows]
        if col.dtype.name == "VARCHAR":
            heap, ends, starts = _varchar(col)
            lengths = (ends - starts)[rows]
            sub_heap, sub_ends = schema.gather_varlen(heap, starts[rows],
                                                      lengths)
            codes = digest.string_codes(torch.from_numpy(sub_heap).to(device),
                                        torch.from_numpy(sub_ends).to(device),
                                        torch.from_numpy(valid).to(device))
            cols[key + "#row"] = (torch.from_numpy(rows.astype(np.int64)).to(device),
                                  torch.from_numpy(valid.copy()).to(device))
        else:
            codes = torch.from_numpy(
                np.where(valid, col.values[rows], 0).astype(np.int64)).to(device)
        cols[key] = (codes, torch.from_numpy(valid.copy()).to(device))
    return Rel(cols, sources)


def join_index(lkey, lvalid, rkey, rvalid):
    """Every (left row, right row) pair with equal non-NULL keys."""
    device = lkey.device
    r_rows = torch.nonzero(rvalid).flatten()
    rk, order = torch.sort(rkey[r_rows], stable=True)
    r_rows = r_rows[order]
    l_rows = torch.nonzero(lvalid).flatten()
    lk = lkey[l_rows]
    lo = torch.searchsorted(rk, lk, side="left")
    cnt = torch.searchsorted(rk, lk, side="right") - lo
    total = int(cnt.sum())
    li = torch.repeat_interleave(l_rows, cnt)
    first = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt)
    ri = r_rows[first + torch.arange(total, device=device)]
    return li, ri


def join(left: Rel, right: Rel, lcol: str, rcol: str) -> Rel:
    """``left ⋈ right`` on ``left.lcol = right.rcol``, every column kept."""
    li, ri = join_index(*left.cols[lcol], *right.cols[rcol])
    out = left.take(li).cols
    out.update(right.take(ri).cols)
    return Rel(out, {**left.sources, **right.sources})
