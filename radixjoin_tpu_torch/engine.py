"""Plan execution engine (port of the main path of radixjoin_tpu/engine.py).

Public surface, as the reference contract (include/plan.h:337-344):

    ctx = build_context(); result = execute(plan, ctx); destroy_context(ctx)

``build_context()`` means the CUDA card and raises without one; the CPU is
used only when a caller asks for it with ``build_context("cpu")``, and then
every kernel wrapper takes its plain PyTorch version.

Data model on the device:
  * every column is (data, valid) — ``data`` int32/int64 (FP64 is carried
    as its int64 bit pattern, which round-trips exactly), ``valid`` bool;
  * VARCHAR columns are dictionary-encoded: int32 ids on the device plus a
    host-side sorted dictionary of ``bytes``;
  * tensors are padded to pow2 buckets, padding rows have ``valid = False``.

Join semantics replicated from the reference:
  * inner equi-join, NULL keys never match (src/execute.cpp:62-83);
  * duplicate keys fan out (src/execute.cpp:232-243);
  * a key-type mismatch between the two sides yields an empty join
    (src/execute.cpp:75-83);
  * output column ``ci`` of a join reads left-child output ``ci`` when
    ``ci < left_width`` else right-child output ``ci - left_width``
    (src/execute.cpp:238-241).

``execute`` runs the fused whole-plan executor (plan/fused.py) inside a
reservation of the device's memory ledger (:class:`DeviceLedger`): cached
uploads are charged to it and evicted, least recently used first, to admit
the next query. A plan whose scan inputs alone exceed the budget
(``RJT_HBM_BUDGET_BYTES``, by default half the device's memory) streams
through the host-staged radix executor (:func:`_execute_host_partitioned`,
ops/radix.py); a ``torch.cuda.OutOfMemoryError`` drops the idle caches and
retries, and after the third failure spills the same way. Every such
degradation is tallied (:func:`engine_stats`); no other exception is
caught. A plan the fused structure declines (a VARCHAR key with no joint
dictionary window) runs on the wave executor (plan/executor.py
``execute_shared``), as does every plan under ``RJT_EXEC_MODE=shared``;
``RJT_EXEC_MODE=stepwise`` runs the stepwise executor
(:func:`execute_device`), which is also the last resort. ``RJT_EXEC_MODE``
is ``auto`` (default), ``fused``, ``shared`` or ``stepwise``.
:func:`execute_many` is the batch form: every admitted plan is dispatched
on its own CUDA stream before any result is consumed.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from . import hardware
from .dtypes import DataType
from .ops import join as join_ops
from .ops import keynorm
from .plan.ir import JoinNode, Plan, ScanNode
from .storage import native
from .storage import page as page_codec
from .storage.columnar import (
    Column,
    ColumnarTable,
    HostColumn,
    HostTable,
    StringDict,
    gather_varlen,
)


@dataclasses.dataclass
class DevColumn:
    """One dense device column + validity, padded to the table bucket."""

    dtype: DataType
    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[StringDict] = None  # sorted distinct values (VARCHAR)


@dataclasses.dataclass
class DevTable:
    num_rows: int  # exact row count; tensors are padded beyond it
    columns: List[DevColumn]

    @property
    def padded_rows(self) -> int:
        return 0 if not self.columns else int(self.columns[0].data.shape[0])


class Context:
    """Engine context: the ``torch.device`` every query of it runs on."""

    def __init__(self, device: torch.device):
        self.device = device
        #: stage breakdown of the last fused execution (see _execute_fused)
        self.last_exec_stats: Optional[dict] = None


def build_context(device=None) -> Context:
    """Context on the CUDA card by default; raises when CUDA is absent.
    ``device="cpu"`` runs the port on the CPU with the kernels' plain
    versions (the tests' oracle)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_context(): CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        device = "cuda"
    return Context(hardware.norm_device(device))


def destroy_context(context: Optional[Context]) -> None:
    return None


# ---------------------------------------------------------------------------
# Host <-> device column conversion
# ---------------------------------------------------------------------------


def host_column_to_device(col: HostColumn, pad: int, device) -> DevColumn:
    n = len(col.valid)
    valid = np.zeros(pad, dtype=bool)
    valid[:n] = col.valid
    dictionary = None
    if col.dtype is DataType.VARCHAR:
        res = native.dict_encode(col.heap, col.ends, col.valid)
        data = np.zeros(pad, dtype=np.int32)
        if res is not None:
            row_ids, dheap, dends = res
            data[:n] = row_ids
            dictionary = StringDict(dheap, dends)
        else:
            present = col.objects()[col.valid]
            if len(present):
                uniq, inverse = np.unique(present, return_inverse=True)
            else:
                uniq, inverse = np.empty(0, dtype=object), np.zeros(0, np.int64)
            data[:n][col.valid] = inverse.astype(np.int32)
            dictionary = StringDict.from_objects(list(uniq))
    elif col.dtype is DataType.FP64:
        data = np.zeros(pad, dtype=np.int64)
        data[:n] = col.values.view(np.int64)
    else:
        data = np.zeros(pad, dtype=col.dtype.numpy_dtype)
        data[:n] = col.values
    return DevColumn(
        col.dtype, torch.from_numpy(data).to(device),
        torch.from_numpy(valid).to(device), dictionary,
    )


def device_column_to_host(col: DevColumn, num_rows: int) -> HostColumn:
    """The first ``num_rows`` rows of a device column, decoded."""
    data = col.data[:num_rows].cpu().numpy()
    valid = col.valid[:num_rows].cpu().numpy()
    return _decode_host_column(col.dtype, data, valid, col.dictionary)


def _decode_host_column(dt: DataType, values: np.ndarray, valid: np.ndarray,
                        dictionary: Optional[StringDict]) -> HostColumn:
    """Fetched device values -> HostColumn: dictionary ids back to strings,
    int64 bit patterns back to FP64."""
    n = len(valid)
    if dt is DataType.VARCHAR:
        d = dictionary or StringDict.empty()
        if n == 0 or d.size == 0:
            return HostColumn.varchar(
                np.zeros(0, np.uint8), np.zeros(n, np.int64), valid)
        ids = np.clip(values, 0, d.size - 1)
        starts = np.where(valid, d.starts[ids], 0)
        lengths = np.where(valid, d.lengths[ids], 0)
        heap, ends = gather_varlen(d.heap, starts, lengths)
        return HostColumn.varchar(heap, ends, valid)
    if dt is DataType.FP64:
        return HostColumn(dt, values.view(np.float64), valid)
    return HostColumn(dt, values, valid)


def paged_column_to_device(pcol, num_rows: int, pad: int,
                           device) -> Optional[DevColumn]:
    """Upload the RAW pages and decode on the device.

    Returns None when the column is not eligible (VARCHAR — dictionary
    building is host-bound — or pages not row-aligned, e.g. the greedy
    reference-parity encoder, or ``RJT_DEVICE_DECODE=off``); callers fall
    back to the host decode + dense upload."""
    from .storage import device_decode as dd

    if not dd.enabled() or pcol.type not in dd.ALIGNED_ROWS:
        return None
    if callable(pcol._pages):
        # lazily-deferred encode (harness path): the dense host arrays
        # already exist and upload directly — forcing a page encode just
        # to decode it back on the device would add work
        return None
    pages = pcol.pages
    if dd.aligned_full_pages(pages, num_rows, pcol.type) is None:
        return None
    data, valid = dd.decode_fixed_device(pages, num_rows, pcol.type, device)
    if pad > num_rows:
        data = join_ops.pad_1d(data, pad)
        valid = join_ops.pad_1d(valid, pad, False)
    return DevColumn(pcol.type, data, valid)


def host_table_to_device(table: HostTable, device) -> DevTable:
    pad = join_ops.bucket_size(table.num_rows)
    return DevTable(
        table.num_rows,
        [host_column_to_device(c, pad, device) for c in table.columns],
    )


def device_table_to_host(table: DevTable) -> HostTable:
    return HostTable(
        table.num_rows,
        [device_column_to_host(c, table.num_rows) for c in table.columns],
    )


# ---------------------------------------------------------------------------
# Join key normalization (stepwise executor)
# ---------------------------------------------------------------------------


def _unify_dictionaries(a: DevColumn, b: DevColumn):
    """Map two dictionary-encoded columns onto one joint id space (exact)."""
    da = a.dictionary.objects() if a.dictionary is not None else np.empty(0, object)
    db = b.dictionary.objects() if b.dictionary is not None else np.empty(0, object)
    ra, rb, _ = keynorm.joint_id_inverse(da, db)

    def remap(col, mapping):
        if mapping.shape[0] == 0:
            return torch.zeros_like(col.data)
        mapping = torch.from_numpy(mapping).to(col.data.device)
        return mapping[col.data.clamp(0, mapping.shape[0] - 1).long()]

    return remap(a, ra), remap(b, rb)


def normalize_join_keys(build: DevColumn, probe: DevColumn):
    """Comparable (key, valid) pairs for both sides, or None when the
    column types cannot match under the reference's variant-extraction
    semantics (the join result is then empty)."""
    bt, pt = build.dtype, probe.dtype
    if bt is not pt:
        return None
    if bt is DataType.VARCHAR:
        kb, kp = _unify_dictionaries(build, probe)
        return (kb, build.valid), (kp, probe.valid)
    if bt is DataType.FP64:
        return (keynorm.canon_f64_bits(build.data, build.valid),
                keynorm.canon_f64_bits(probe.data, probe.valid))
    return (build.data, build.valid), (probe.data, probe.valid)


# ---------------------------------------------------------------------------
# Stepwise execution: one node at a time, two-phase sort joins
# ---------------------------------------------------------------------------


def _execute_scan(input_table: ColumnarTable, output_attrs, device) -> DevTable:
    """Decode the paged input and project ``output_attrs`` (column
    selection, free). Row-aligned fixed-width columns upload raw pages and
    decode on the device; others decode on the host and upload dense."""
    pad = join_ops.bucket_size(input_table.num_rows)
    host = None
    cols = []
    for col_idx, dt in output_attrs:
        pcol = input_table.columns[col_idx]
        if pcol.type is not dt:
            raise TypeError(
                f"scan output attr {col_idx}: declared {dt}, stored {pcol.type}"
            )
        col = paged_column_to_device(pcol, input_table.num_rows, pad, device)
        if col is None:
            if host is None:
                host = input_table.to_host()
            col = host_column_to_device(host.columns[col_idx], pad, device)
        cols.append(col)
    return DevTable(input_table.num_rows, cols)


def _empty_result(output_attrs, device) -> DevTable:
    pad = join_ops.bucket_size(0)
    cols = []
    for _, dt in output_attrs:
        data_dtype = (torch.int32 if dt in (DataType.INT32, DataType.VARCHAR)
                      else torch.int64)
        cols.append(DevColumn(
            dt,
            torch.zeros(pad, dtype=data_dtype, device=device),
            torch.zeros(pad, dtype=torch.bool, device=device),
            StringDict.empty() if dt is DataType.VARCHAR else None,
        ))
    return DevTable(0, cols)


def _execute_join(left: DevTable, right: DevTable, join: JoinNode,
                  output_attrs, device) -> DevTable:
    if left.num_rows == 0 or right.num_rows == 0:
        return _empty_result(output_attrs, device)

    if join.build_left:
        build, probe = left, right
        build_attr, probe_attr = join.left_attr, join.right_attr
    else:
        build, probe = right, left
        build_attr, probe_attr = join.right_attr, join.left_attr

    keys = normalize_join_keys(build.columns[build_attr],
                               probe.columns[probe_attr])
    if keys is None:
        return _empty_result(output_attrs, device)
    (kb, vb), (kp, vp) = keys

    bidx, pidx, live, total = join_ops.join_count_and_index(kb, vb, kp, vp)
    if total == 0:
        return _empty_result(output_attrs, device)

    lidx = bidx if join.build_left else pidx
    ridx = pidx if join.build_left else bidx

    left_w = len(left.columns)
    out_cols: List[DevColumn] = []
    for ci, dt in output_attrs:
        if ci < left_w:
            src, idx = left.columns[ci], lidx
        else:
            src, idx = right.columns[ci - left_w], ridx
        [(data, valid)] = join_ops.gather_columns(
            [(src.data, src.valid)], idx, live)
        out_cols.append(DevColumn(dt, data, valid, src.dictionary))
    return DevTable(total, out_cols)


def execute_device(plan: Plan, context: Optional[Context] = None) -> DevTable:
    """Run the plan node by node, returning the root as a dense device
    table. Serves ``RJT_EXEC_MODE=stepwise`` and every plan the fused
    structure declines; its uploads are not cached."""
    if context is None:
        context = build_context()
    device = context.device
    plan.validate()
    results = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            results[idx] = _execute_scan(
                plan.inputs[node.data.base_table_id], node.output_attrs,
                device,
            )
        else:
            results[idx] = _execute_join(
                results[node.data.left],
                results[node.data.right],
                node.data,
                node.output_attrs,
                device,
            )
    return results[plan.root]


# ---------------------------------------------------------------------------
# Device-memory ledger
# ---------------------------------------------------------------------------

#: plans carrying a ``_fused_struct_cache`` (it holds references to cached
#: device columns; dropped whenever a ledger evicts anything, so that an
#: evicted tensor loses its last reference and is really freed)
_DEVICE_CACHE_PLANS: dict = {}


def register_device_cache_plan(plan) -> None:
    key = id(plan)
    if key not in _DEVICE_CACHE_PLANS:
        _DEVICE_CACHE_PLANS[key] = weakref.ref(
            plan, lambda _r, k=key: _DEVICE_CACHE_PLANS.pop(k, None))


def _drop_fused_struct_caches() -> None:
    for ref in list(_DEVICE_CACHE_PLANS.values()):
        plan = ref()
        if plan is not None:
            plan._fused_struct_cache = None


class _LedgerEntry:
    __slots__ = ("ref", "nbytes", "seq", "release", "users")

    def __init__(self, ref, nbytes, seq, release):
        self.ref = ref  # weakref to the owning host object
        self.nbytes = nbytes
        self.seq = seq
        self.release = release
        self.users: set = set()  # active query tokens that touched this


class DeviceLedger:
    """Deterministic device-memory accounting for one device.

    Cross-query caches (column upload memos, CSR indexes) would otherwise
    grow until the allocator fails. The ledger replaces that with
    bookkeeping:

    * every cross-query cache upload **charges** its exact byte count and
      a release callback;
    * before a query dispatches, :meth:`reserve` admits it only once
      ``idle-pinned + active reservations + estimate <= budget``, evicting
      least-recently-used *idle* entries to make room — entries touched by
      an in-flight query are never evicted;
    * concurrent queries (threads, ``execute_many``) are
      admission-controlled: a query that cannot fit next to the in-flight
      set blocks until one finishes (or runs alone as a best-effort
      backstop; the out-of-memory ladder of ``execute`` stands behind it).

    A tensor is freed only when its last reference goes, so a release
    callback must drop every reference the engine holds; the ledger then
    drops the cached plan structures too. The reference has no analogue (a
    512 GB shared-memory host never tracked its working set); this is the
    device-memory tier's equivalent of its L2-sized radix buckets
    (src/execute.cpp:86-92).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: dict = {}  # id(owner) -> _LedgerEntry
        self._reservations: dict = {}  # token -> bytes
        self._seq = 0
        self._local = threading.local()
        self.stats = {"evictions": 0, "evicted_bytes": 0, "waits": 0,
                      "charged_bytes": 0}

    # -- token context ----------------------------------------------------

    def _tokens(self) -> list:
        toks = getattr(self._local, "tokens", None)
        if toks is None:
            toks = self._local.tokens = []
        return toks

    def activate(self, token):
        """Context manager: attribute charges/touches on this thread to
        ``token`` (execute_many interleaves many queries on one thread)."""
        ledger = self

        class _Ctx:
            def __enter__(self):
                ledger._tokens().append(token)

            def __exit__(self, *exc):
                ledger._tokens().pop()

        return _Ctx()

    # -- charging ---------------------------------------------------------

    def charge(self, owner, nbytes: int, release) -> None:
        """Record ``nbytes`` of device memory pinned by ``owner`` (adds to
        any previous charge for the same owner). ``release(owner)`` must
        drop every reference to the device tensors the owner caches."""
        key = id(owner)
        with self._cond:
            e = self._entries.get(key)
            if e is None:
                ref = weakref.ref(owner, lambda _r, k=key: self._forget(k))
                e = self._entries[key] = _LedgerEntry(ref, 0, 0, release)
            e.nbytes += int(nbytes)
            self.stats["charged_bytes"] += int(nbytes)  # cumulative uploads
            self._seq += 1
            e.seq = self._seq
            e.users.update(self._tokens())

    def touch(self, owner) -> bool:
        """LRU-touch ``owner``'s entry and attribute it to the thread's
        active query token (protecting it from eviction for the rest of
        the query). Returns False when the entry is GONE — the owner was
        evicted (pop + release run atomically under this same lock, so a
        True return means the owner's memo was live at this instant and is
        now token-protected). Callers treating a cached tensor as current
        MUST check this result: it is the only sign of a stale memo."""
        key = id(owner)
        with self._cond:
            e = self._entries.get(key)
            if e is None:
                return False
            self._seq += 1
            e.seq = self._seq
            e.users.update(self._tokens())
            return True

    def _forget(self, key) -> None:
        with self._cond:
            self._entries.pop(key, None)

    # -- accounting -------------------------------------------------------

    def pinned_bytes(self) -> int:
        with self._cond:
            return sum(e.nbytes for e in self._entries.values())

    def _evict_locked(self, need: int, protect: set) -> int:
        """Evict idle LRU entries until ``need`` bytes are freed (or no
        idle entries remain). Returns bytes freed. Lock held."""
        freed = 0
        cand = sorted(
            ((k, e) for k, e in self._entries.items()
             if e.users.isdisjoint(protect)),
            key=lambda kv: kv[1].seq,
        )
        for key, e in cand:
            if freed >= need:
                break
            self._entries.pop(key, None)
            owner = e.ref()
            if owner is not None:
                e.release(owner)
            freed += e.nbytes
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += e.nbytes
        if freed:
            _drop_fused_struct_caches()
        return freed

    def evict_idle(self) -> int:
        """Evict every entry not in use by an in-flight query."""
        with self._cond:
            live = set(self._reservations)
            return self._evict_locked(1 << 62, live)

    def reserve(self, est: int, budget: int, block: bool = True):
        """Admit a query with an ``est``-byte working set under ``budget``.

        Evicts idle cache entries to fit; blocks (when ``block``) until
        concurrent reservations drain if still over; proceeds best-effort
        when running alone. Returns a :class:`_Reservation`, or None when
        ``block=False`` and the query cannot fit next to the current
        in-flight set."""
        token = object()
        with self._cond:
            while True:
                live = set(self._reservations)
                pinned = sum(e.nbytes for e in self._entries.values())
                reserved = sum(self._reservations.values())
                over = pinned + reserved + est - budget
                if over > 0:
                    over -= self._evict_locked(over, live | {token})
                if over <= 0 or not self._reservations:
                    break  # fits, or alone: best-effort
                if not block:
                    return None
                self.stats["waits"] += 1
                self._cond.wait(timeout=60.0)
            self._reservations[token] = est
        return _Reservation(self, token)

    def release(self, token) -> None:
        with self._cond:
            self._reservations.pop(token, None)
            for e in self._entries.values():
                e.users.discard(token)
            self._cond.notify_all()


class _Reservation:
    """One admitted query's budget hold. As a context manager it also
    attributes the thread's charges to the query (the single-threaded
    ``execute()`` shape); ``execute_many`` instead holds the reservation
    across generator steps and wraps each step in
    ``ledger.activate(res.token)``."""

    def __init__(self, ledger: "DeviceLedger", token):
        self._ledger = ledger
        self.token = token
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ledger.release(self.token)

    def __enter__(self):
        self._ledger._tokens().append(self.token)
        return self

    def __exit__(self, *exc):
        self._ledger._tokens().pop()
        self.close()


#: one ledger per device: a process may run plans on the card and, through
#: ``build_context("cpu")``, on the CPU, and each has its own budget
_LEDGERS: dict = {}
_LEDGERS_LOCK = threading.Lock()


def device_ledger(device=None) -> DeviceLedger:
    """The ledger of ``device``; the default is the CUDA card, and raises
    where there is none (pass ``"cpu"`` for the CPU route's ledger)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_ledger(): CUDA is not available; pass 'cpu' for the "
                "CPU route's ledger"
            )
        device = "cuda"
    device = hardware.norm_device(device)
    ledger = _LEDGERS.get(device)
    if ledger is None:
        with _LEDGERS_LOCK:
            ledger = _LEDGERS.setdefault(device, DeviceLedger())
    return ledger


def _release_column_caches(owner, device: torch.device) -> None:
    """Ledger release callback for a host/paged column: drop every
    reference its memo holds to tensors on ``device`` (column uploads and
    the CSR index; ``ineligible`` markers are host knowledge and survive).
    The ledger drops the cached plan structures, the only other holders."""
    from .plan import executor as _exec

    memo = getattr(owner, "_dev_memo", None)
    if memo:
        for k in [k for k in memo if k != "ineligible"
                  and _exec._memo_key_device(k) == device]:
            memo.pop(k)


@functools.lru_cache(maxsize=None)
def column_cache_release(device: torch.device):
    """The release callback the upload memos charge with on ``device``."""
    return functools.partial(_release_column_caches, device=device)


def clear_device_caches() -> None:
    """Drop every *idle* device cache on every device (upload memos, CSR
    indexes, fused plan structures), then hand the freed blocks back from
    the caching allocator. Called on ``torch.cuda.OutOfMemoryError``;
    callers retry and repopulate lazily. Entries in use by other in-flight
    queries are left alone."""
    for ledger in list(_LEDGERS.values()):
        ledger.evict_idle()
    _drop_fused_struct_caches()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _is_oom(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError)


#: process-wide degradation tallies: a run that degraded says so. Read via
#: :func:`engine_stats`. ``infra_fallbacks`` belongs to a degrade path of
#: the JAX package that has no counterpart here; it stays 0 so that both
#: packages report the same keys.
ENGINE_STATS: dict = {
    "infra_fallbacks": 0,
    "oom_retries": 0,            # out of memory -> cache-drop retry
    "oom_host_spills": 0,        # retry ladder exhausted -> host-staged
    "admission_host_spills": 0,  # inputs alone exceed the budget
}
#: query names (plan._name) that degraded, per kind — same keys
ENGINE_STATS_QUERIES: dict = {k: [] for k in ENGINE_STATS}


def engine_stats() -> dict:
    out = dict(ENGINE_STATS)
    out["queries"] = {k: list(v) for k, v in ENGINE_STATS_QUERIES.items()
                      if v}
    return out


def reset_engine_stats() -> None:
    for k in ENGINE_STATS:
        ENGINE_STATS[k] = 0
        ENGINE_STATS_QUERIES[k].clear()


def _tally(kind: str, plan) -> None:
    ENGINE_STATS[kind] += 1
    name = getattr(plan, "_name", None)
    if name is not None:
        ENGINE_STATS_QUERIES[kind].append(str(name))


# ---------------------------------------------------------------------------
# Fused whole-plan execution
# ---------------------------------------------------------------------------


def _detect_unique_joins(plan: Plan) -> frozenset:
    """Join nodes whose build side is a scan column with verified-unique
    valid keys (FK->PK). The root is excluded: unique-join output is
    probe-shaped/uncompacted, and the result extraction slices the root to
    ``[:total]`` which assumes compacted rows."""
    unique = set()
    for idx, node in enumerate(plan.nodes):
        if idx == plan.root or not isinstance(node.data, JoinNode):
            continue
        j = node.data
        build_child = plan.nodes[j.left if j.build_left else j.right]
        if not isinstance(build_child.data, ScanNode):
            continue
        battr = j.left_attr if j.build_left else j.right_attr
        col_idx, dt = build_child.output_attrs[battr]
        if dt not in (DataType.INT32, DataType.INT64):
            continue
        host = plan.inputs[build_child.data.base_table_id].to_host()
        if host.columns[col_idx].is_unique_key():
            unique.add(idx)
    return frozenset(unique)


def _fetch(tensors) -> List[np.ndarray]:
    """Blocking fetch of a generator's request."""
    return [t.cpu().numpy() for t in tensors]


def _execute_fused(plan: Plan, context: Context) -> Optional[HostTable]:
    """Drive :func:`_fused_attempts` to its end, fetching each request as
    it comes. Returns the decoded root table, or None when the plan cannot
    fuse. Leaves a stage breakdown of this execution (dispatch, fetch and
    decode milliseconds on the host clock, fetch rounds) on the plan and
    the context as ``_last_exec_stats`` / ``last_exec_stats``."""
    gen = _fused_attempts(plan, context)
    stats = {"dispatch_ms": 0.0, "fetch_ms": 0.0, "rounds": 0}
    t0 = time.perf_counter()
    try:
        req = next(gen)
        while True:
            t1 = time.perf_counter()
            stats["dispatch_ms"] += (t1 - t0) * 1e3
            fetched = _fetch(req)
            t0 = time.perf_counter()
            stats["fetch_ms"] += (t0 - t1) * 1e3
            stats["rounds"] += 1
            req = gen.send(fetched)
    except StopIteration as stop:
        stats["decode_ms"] = (time.perf_counter() - t0) * 1e3
        plan._last_exec_stats = stats
        context.last_exec_stats = stats
        return stop.value


def _fused_attempts(plan: Plan, context: Context):
    """Generator form of the fused executor: yields lists of device
    tensors whose fetched numpy values are sent back in, and returns the
    decoded HostTable (or None when the plan cannot fuse). Separating
    dispatch from fetch lets :func:`execute_many` dispatch many plans
    before it consumes any result.

    Per attempt: build (or revalidate and reuse) the structure for the
    current bucket state, run it, and ask for the per-join totals. A
    general join whose total exceeded its bucket re-runs with the exact
    bucket; joins above an overflowed join are not trustworthy and double
    their bucket; a probe-shaped join compacted to a stale learned pad
    re-runs uncompacted. On success the exact buckets are kept on the plan
    object as cardinality feedback for its next execution, and the root's
    live rows (``[:root_total]``, exact) are asked for and decoded."""
    from .plan import executor as _exec
    from .plan import fused as fz

    register_device_cache_plan(plan)
    device = context.device
    buckets: dict = {}
    root_node = plan.nodes[plan.root]
    unique_joins = _detect_unique_joins(plan)
    feedback_on = _exec.card_feedback_on()
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    # a structure built under other knob values must not be served
    knobs = _exec.strategy_knobs()
    if learned:
        for i, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(i, pad)
    no_compact: set = set()
    for _attempt in range(len(plan.nodes) + 2):
        state_key = (
            device,
            knobs,
            tuple(sorted(buckets.items())),
            tuple(sorted(learned.items())) if learned else None,
            frozenset(no_compact),
        )
        cached = getattr(plan, "_fused_struct_cache", None)
        if (
            cached is not None
            and cached[0] == state_key
            and cached[1].revalidate()
        ):
            structure = cached[1]
        else:
            structure = fz.FusedPlan(
                plan, buckets, unique_joins, device, learned,
                frozenset(no_compact),
            )
            plan._fused_struct_cache = (state_key, structure)
        if structure.has_varchar_key:
            return None  # the caller falls back to the wave executor
        out_values_dev, out_valid_dev, totals_dev = fz.run(structure)
        (totals,) = yield [totals_dev]

        # exactness: a join's total is trustworthy iff no descendant
        # general join overflowed its bucket; probe-shaped strategies
        # cannot overflow
        join_order = structure.join_order
        exact: dict = {}
        overflow = False
        for ji, node_id in enumerate(join_order):
            spec = structure.join_specs[node_id]
            probe_shaped = spec.strategy in (
                "unique_scatter", "unique_sort", "empty"
            )
            deps_ok = all(exact.get(d, True) for d in (spec.left, spec.right))
            fits = probe_shaped or int(totals[ji]) <= spec.out_pad
            if spec.compact_pad and int(totals[ji]) > spec.compact_pad:
                # stale learned pad truncated this probe-shaped output
                no_compact.add(node_id)
                fits = False
                overflow = True
            exact[node_id] = deps_ok and fits
            if probe_shaped:
                continue
            if deps_ok and not fits:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
                overflow = True
            elif not deps_ok:
                buckets[node_id] = max(
                    buckets.get(node_id, spec.out_pad) * 2, spec.out_pad * 2
                )
                overflow = True
            else:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
        if overflow:
            del out_values_dev, out_valid_dev  # free before the re-run
            continue

        if isinstance(root_node.data, ScanNode):
            root_total = plan.inputs[root_node.data.base_table_id].num_rows
        else:
            root_total = int(totals[join_order.index(plan.root)])

        # per-join exact output cardinalities of this execution
        plan._last_join_totals = {
            node_id: int(totals[ji]) for ji, node_id in enumerate(join_order)
        }
        if feedback_on:
            plan._learned_buckets = {
                node_id: (
                    join_ops.bucket_size(int(totals[ji])),
                    structure.join_specs[node_id].strategy
                    not in ("unique_scatter", "unique_sort"),
                )
                for ji, node_id in enumerate(join_order)
            }

        # bounded root fetch: only the live rows cross to the host
        k = len(out_values_dev)
        fetched = yield [v[:root_total] for v in out_values_dev] + [
            v[:root_total] for v in out_valid_dev]
        out_values, out_valid = fetched[:k], fetched[k:]

        sources = structure.col_sources[plan.root]
        cols = [
            _decode_host_column(dt, out_values[ko], out_valid[ko],
                                structure.dicts[sources[ko]])
            for ko, (_ci, dt) in enumerate(root_node.output_attrs)
        ]
        return HostTable(root_total, cols)
    raise RuntimeError("fused plan did not converge to exact buckets")


# ---------------------------------------------------------------------------
# Host-staged multi-pass radix execution (inputs exceed the device budget)
# ---------------------------------------------------------------------------


def _host_normalize_keys(b: HostColumn, p: HostColumn):
    """Comparable (key, valid) numpy pairs, or None on a type mismatch
    (same semantics as :func:`normalize_join_keys`, host side)."""
    if b.dtype is not p.dtype:
        return None
    if b.dtype is DataType.VARCHAR:
        bo = np.where(b.valid, b.objects(), b"")
        po = np.where(p.valid, p.objects(), b"")
        rb_, rp_, _ = keynorm.joint_id_inverse(bo, po)
        return (
            (rb_.astype(np.int64), b.valid),
            (rp_.astype(np.int64), p.valid),
        )
    if b.dtype is DataType.FP64:
        def canon(col):
            return keynorm.canon_f64_bits(
                col.values.view(np.int64), col.valid
            )
        return canon(b), canon(p)
    return (b.values, b.valid), (p.values, p.valid)


def _empty_host_table(output_attrs) -> HostTable:
    cols = []
    for _, dt in output_attrs:
        if dt is DataType.VARCHAR:
            cols.append(HostColumn.varchar(
                np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, bool)
            ))
        else:
            cols.append(HostColumn(
                dt, np.zeros(0, dt.numpy_dtype), np.zeros(0, bool)
            ))
    return HostTable(0, cols)


def _execute_host_partitioned(plan: Plan, budget_bytes: Optional[int],
                              device) -> HostTable:
    """Spill executor: tables stay on the host; every join streams hash
    partitions through ``device`` pair by pair (ops/radix.py), and
    materialization is a host-side ``take`` at the surviving row pairs.

    This is the multi-pass generalization of the reference's single L2
    radix pass (src/execute.cpp:86-92) to the split between host memory
    and device memory. ``plan._last_spill_partitions`` keeps the partition
    count of each join of the last run."""
    from .ops import radix

    results: dict = {}
    partitions: dict = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            host = plan.inputs[node.data.base_table_id].to_host()
            cols = []
            for ci, dt in node.output_attrs:
                col = host.columns[ci]
                if col.dtype is not dt:
                    raise TypeError(
                        f"scan output attr {ci}: declared {dt}, stored {col.dtype}"
                    )
                cols.append(col)
            results[idx] = HostTable(host.num_rows, cols)
            continue

        j = node.data
        left, right = results[j.left], results[j.right]
        if left.num_rows == 0 or right.num_rows == 0:
            results[idx] = _empty_host_table(node.output_attrs)
            continue
        if j.build_left:
            build, probe = left, right
            battr, pattr = j.left_attr, j.right_attr
        else:
            build, probe = right, left
            battr, pattr = j.right_attr, j.left_attr
        keys = _host_normalize_keys(build.columns[battr], probe.columns[pattr])
        if keys is None:
            results[idx] = _empty_host_table(node.output_attrs)
            continue
        (kb, vb), (kp, vp) = keys
        partitions[idx] = radix.choose_num_partitions(
            len(kb), len(kp), budget_bytes=budget_bytes, device=device)
        bidx, pidx = radix.partitioned_join_indices(
            kb, vb, kp, vp, num_partitions=partitions[idx], device=device
        )
        lidx = bidx if j.build_left else pidx
        ridx = pidx if j.build_left else bidx
        left_w = len(left.columns)
        cols = []
        for ci, dt in node.output_attrs:
            src, sel = (left.columns[ci], lidx) if ci < left_w else (
                right.columns[ci - left_w], ridx
            )
            cols.append(src.take(sel))
        results[idx] = HostTable(len(lidx), cols)
    plan._last_spill_partitions = partitions
    return results[plan.root]


def _esize(dt) -> int:
    return 4 if dt in (DataType.INT32, DataType.VARCHAR) else 8


def _estimate_scan_bytes(plan: Plan) -> int:
    """Padded device footprint of all scan inputs (pow2 pad, values+valid),
    deduplicated: a (table, column) shared by several scan nodes uploads
    once through the memo."""
    seen = set()
    total = 0
    for node in plan.nodes:
        if not isinstance(node.data, ScanNode):
            continue
        pad = join_ops.bucket_size(plan.inputs[node.data.base_table_id].num_rows)
        for ci, dt in node.output_attrs:
            key = (node.data.base_table_id, ci)
            if key not in seen:
                seen.add(key)
                total += pad * (_esize(dt) + 1)
    return total


def _estimate_query_bytes(plan: Plan) -> int:
    """Working-set estimate of one query's device execution: the scan
    inputs (live for the whole run) plus the largest join's output buffers
    and sort / expansion transients — not the sum of every join output,
    since a join's intermediates are freed as the walk moves on. Learned
    cardinality-feedback buckets shrink the estimate on repeat executions
    exactly like they shrink the real footprint."""
    feedback = getattr(plan, "_learned_buckets", None) or {}
    pads: dict = {}
    max_out = 0
    max_transient = 0
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            pads[idx] = join_ops.bucket_size(
                plan.inputs[node.data.base_table_id].num_rows
            )
            continue
        j = node.data
        bpad = pads[j.left if j.build_left else j.right]
        ppad = pads[j.right if j.build_left else j.left]
        learned = feedback.get(idx)
        out_pad = learned[0] if learned else ppad
        pads[idx] = out_pad
        # output columns + expansion scratch (bidx/pidx/live/marker ~13B)
        row_bytes = sum(_esize(dt) + 1 for _, dt in node.output_attrs) + 13
        max_out = max(max_out, out_pad * row_bytes)
        # merge-join sort of (build ++ probe) packed i64, in + out
        max_transient = max(max_transient, (bpad + ppad) * 16)
    return _estimate_scan_bytes(plan) + max_out + max_out // 2 + max_transient


def _hbm_budget(context: Context) -> int:
    """Device-resident working-set budget in bytes (the spill threshold):
    ``RJT_HBM_BUDGET_BYTES``, or half the memory of the context's device.
    Shared by execute() and execute_many() so a plan spills identically
    in both."""
    env_budget = os.environ.get("RJT_HBM_BUDGET_BYTES")
    if env_budget:
        return int(env_budget)
    return hardware.detect(context.device).hbm_bytes // 2


def _exec_mode() -> str:
    mode = os.environ.get("RJT_EXEC_MODE", "auto")
    if mode not in ("auto", "fused", "shared", "stepwise"):
        raise ValueError(f"RJT_EXEC_MODE={mode!r}: expected auto, fused, "
                         "shared or stepwise")
    return mode


def execute(plan: Plan, context: Optional[Context] = None) -> ColumnarTable:
    """Evaluate ``plan`` and encode the result as a paged ColumnarTable
    (the reference ``Contest::execute``, src/execute.cpp:316-324).

    Runs the fused whole-plan executor when the working set fits the
    device budget, inside a ledger reservation that evicts idle cached
    uploads to make room; spills to the host-staged multi-pass radix
    executor when the scan inputs alone exceed the budget. The wave
    executor serves the rare plan the fused structure declines (a VARCHAR
    key with no joint dictionary window) and ``RJT_EXEC_MODE=shared``; the
    stepwise executor is the last resort. ``torch.cuda.OutOfMemoryError``
    is the one exception caught: idle caches are dropped and the plan is
    retried, twice, before it spills; every such step is tallied
    (:func:`engine_stats`)."""
    if context is None:
        context = build_context()
    device = context.device
    plan.validate()
    budget = _hbm_budget(context)
    mode = _exec_mode()
    ledger = device_ledger(device)

    def _run_on_device() -> HostTable:
        from .plan import executor

        host = None
        if mode in ("auto", "fused"):
            host = _execute_fused(plan, context)
        if host is None and mode != "stepwise":
            # shared mode, or the fused structure declined the plan (a
            # VARCHAR key it cannot window): the wave executor unifies the
            # dictionaries itself
            host = executor.execute_shared(
                plan, _detect_unique_joins(plan), device)
            context.last_exec_stats = plan._last_exec_stats
        if host is None:
            host = device_table_to_host(execute_device(plan, context))
        return host

    if _estimate_scan_bytes(plan) > budget:
        # the inputs alone exceed the budget: host-staged multi-pass radix
        _tally("admission_host_spills", plan)
        ledger.evict_idle()
        host = _execute_host_partitioned(plan, budget // 8, device)
        return _encode_result(host)

    est = min(_estimate_query_bytes(plan), budget)
    with ledger.reserve(est, budget):
        host = None
        for attempt in range(3):
            try:
                host = _run_on_device()
                break
            except torch.cuda.OutOfMemoryError:
                # the estimate was short (e.g. the first run of a plan
                # with a large fan-out). The exception's traceback holds
                # the failed run's tensors, so the caches are dropped
                # after this block, once it is gone.
                if attempt == 0:
                    _tally("oom_retries", plan)
                elif attempt == 2:
                    _tally("oom_host_spills", plan)
            clear_device_caches()
        if host is None:
            # the query alone does not fit: stream it through the
            # host-staged multi-pass radix executor
            host = _execute_host_partitioned(plan, budget // 8, device)
    return _encode_result(host)


def _encode_result(host: HostTable) -> ColumnarTable:
    """HostTable -> paged ColumnarTable (the reference's final
    to_columnar step, src/execute.cpp:322-323)."""
    cols = []
    for c in host.columns:
        if c.dtype is DataType.VARCHAR:
            pages = page_codec.encode_varchar_heap(c.heap, c.ends, c.valid)
        else:
            pages = page_codec.encode_fixed(c.values, c.valid, c.dtype)
        cols.append(Column(c.dtype, pages))
    return ColumnarTable(host.num_rows, cols)


# ---------------------------------------------------------------------------
# Batch execution
# ---------------------------------------------------------------------------


class _PendingFetch:
    """A generator's request on its way to the host. On a CUDA stream each
    tensor is copied with ``non_blocking=True`` into pinned host memory on
    that stream and an event marks the end of the copies; :meth:`wait`
    blocks on the event only. The device tensors are kept until then."""

    def __init__(self, tensors, stream):
        self._event = None
        if stream is None:
            self._host = [t.cpu() for t in tensors]
            return
        self._src = list(tensors)
        self._host = [
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors
        ]
        with torch.cuda.stream(stream):
            for h, t in zip(self._host, self._src):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
            self._src = None
        return [h.numpy() for h in self._host]


def execute_many(
    plans: List[Plan], context: Optional[Context] = None
) -> List[ColumnarTable]:
    """Throughput mode: evaluate a batch of plans with overlapped dispatch
    and host transfers.

    ``execute`` is latency-shaped (the reference's per-query contract,
    src/execute.cpp:316-324): each call dispatches, then blocks on its own
    result fetch. This batch form runs the same fused plans but phases the
    work across queries: every admitted plan is dispatched first, each on
    its own CUDA stream; each plan's requested tensors then start their
    device-to-host copy into pinned memory on that stream; and only then
    are the results consumed, in order, each behind its own event — so
    device work, transfers and the host's decode and page encode overlap
    instead of serializing. Plans are admitted cheapest first under the
    same budget as ``execute``; one that does not fit next to the in-flight
    set waits for a drain round. Plans the fused structure declines, whose
    inputs exceed the budget or that ran out of memory fall back to
    :func:`execute` (its wave executor, spill and out-of-memory ladder,
    which tallies its own retries) on the caller's stream. Results
    are identical to per-plan ``execute`` calls, in input order.
    """
    if context is None:
        context = build_context()
    if _exec_mode() not in ("auto", "fused"):
        return [execute(p, context) for p in plans]
    device = context.device
    on_card = device.type == "cuda"
    ledger = device_ledger(device)
    budget = _hbm_budget(context)

    results: List[Optional[ColumnarTable]] = [None] * len(plans)
    live: dict = {}  # idx -> (generator, pending fetch)
    tokens: dict = {}  # idx -> ledger reservation
    streams: dict = {}  # idx -> the plan's CUDA stream (None on the CPU)
    fallbacks: List[int] = []

    def _release(idx: int) -> None:
        res = tokens.pop(idx, None)
        if res is not None:
            res.close()

    def _finish(idx: int, host) -> None:
        _release(idx)
        if host is None:  # fused structure declined: single-plan fallback
            fallbacks.append(idx)
        else:
            results[idx] = _encode_result(host)

    def _step(idx: int, gen, fetched) -> None:
        """Advance one plan's generator by one step, on the plan's stream
        and under its ledger token: to its next fetch request (whose
        copies are started at once) or to its end."""
        stream = streams[idx]
        oom = False
        try:
            with ledger.activate(tokens[idx].token):
                if stream is None:
                    req = gen.send(fetched)
                else:
                    with torch.cuda.stream(stream):
                        req = gen.send(fetched)
        except StopIteration as stop:
            _finish(idx, stop.value)
            return
        except torch.cuda.OutOfMemoryError:
            oom = True  # handled below, once the traceback is gone
        if oom:
            gen.close()
            _release(idx)
            clear_device_caches()
            fallbacks.append(idx)  # retried through execute()'s ladder
            return
        live[idx] = (gen, _PendingFetch(req, stream))

    def _try_start(idx: int) -> bool:
        """Admit + dispatch one plan; False = does not fit next to the
        in-flight set right now (the caller retries after a drain round)."""
        plan = plans[idx]
        est = min(_estimate_query_bytes(plan), budget)
        res = ledger.reserve(est, budget, block=False)
        if res is None:
            return False
        tokens[idx] = res
        streams[idx] = torch.cuda.Stream(device) if on_card else None
        if on_card:
            # the plan's stream starts behind whatever the caller's stream
            # has queued (uploads, earlier results)
            streams[idx].wait_stream(torch.cuda.current_stream(device))
        _step(idx, _fused_attempts(plan, context), None)
        return True

    try:
        # Admission-aware start order: the cheapest queries first — many
        # small reservations co-admit and overlap — and the giants
        # serialize through admission at the end, where they no longer
        # block the small ones.
        deferred: List[int] = []
        order_sm = sorted(
            range(len(plans)),
            key=lambda i: min(_estimate_query_bytes(plans[i]), budget),
        )
        for idx in order_sm:
            plan = plans[idx]
            plan.validate()
            if _estimate_scan_bytes(plan) > budget:
                fallbacks.append(idx)  # spill path, host-staged
                continue
            if not _try_start(idx):
                deferred.append(idx)  # admission-controlled: start post-drain

        while live or deferred:
            if not live:
                # admission: with nothing in flight the reserve always admits
                _try_start(deferred.pop(0))
                continue
            # consume in index order; an overflow retry re-enters ``live``
            # and is drained on the next round (cold runs only)
            for idx in sorted(live):
                gen, pending = live.pop(idx)
                _step(idx, gen, pending.wait())
            # freed reservations admit deferred plans for the next round
            deferred = [idx for idx in deferred if not _try_start(idx)]
        # Serial fallbacks (declined, over-budget or out-of-memory plans)
        # run once nothing is in flight: ``execute`` reserves with
        # ``block=True``, and on this thread no reservation of the batch
        # would ever drain.
        for idx in fallbacks:
            results[idx] = execute(plans[idx], context)
    finally:
        # a plan that raised leaves the others' reservations behind
        for idx in list(tokens):
            _release(idx)
    if on_card:
        # later work on the caller's stream sees every plan's stream done
        for stream in streams.values():
            torch.cuda.current_stream(device).wait_stream(stream)
    return results
