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

import atexit
import dataclasses
import functools
import gc
import hashlib
import json
import os
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from . import hardware, trace
from .dtypes import DataType
from .ops import join as join_ops
from .ops import kernels, keynorm
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
    _feedback_store().save()
    return None


# ---------------------------------------------------------------------------
# Cross-process cardinality feedback
# ---------------------------------------------------------------------------


class _FeedbackStore:
    """Cross-process persistence of cardinality feedback (the JAX package's
    store, with its key and its JSON entry, so one file serves both).

    Learned per-join exact buckets (the state the fused executor starts a
    repeat execution from) keyed by a content hash of the plan *and its
    input row counts*: a fresh process running a known plan makes no
    default-bucket pass and no overflow retry. One JSON file, written
    atomically (a temporary file, then ``os.replace``) after exact runs are
    recorded, at :func:`destroy_context` and at exit. A stale entry is
    harmless: an undersized learned pad takes the ordinary overflow retry.

    ``RJT_FEEDBACK_PATH`` names the file, read once on the store's first
    use; unset or empty, the store is off (the JAX package's default
    location is its compile-cache directory, which this package has no
    counterpart of). A file that cannot be read or parsed is ignored, one
    that cannot be written is skipped; both are tallied in :attr:`stats`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Optional[dict] = None  # {key: [buckets, root_rows]}
        self._path: Optional[str] = None  # set with _data, on first use
        self._dirty = False
        self.stats = {"loaded": 0, "saves": 0, "load_errors": 0,
                      "save_errors": 0}

    def _load_locked(self) -> Optional[dict]:
        """The store's entries, read on first use; None when it is off."""
        if self._data is None:
            self._path = os.environ.get("RJT_FEEDBACK_PATH") or None
            self._data = {}
            if self._path and os.path.exists(self._path):
                try:
                    with open(self._path) as f:
                        data = json.load(f)
                    if not isinstance(data, dict):
                        raise ValueError("not a JSON object")
                    self._data = data
                except (OSError, ValueError):
                    self.stats["load_errors"] += 1
        return self._data if self._path else None

    @staticmethod
    def _key(plan: Plan) -> str:
        key = getattr(plan, "_feedback_key", None)
        if key is None:
            desc = []
            for node in plan.nodes:
                attrs = tuple((c, int(dt)) for c, dt in node.output_attrs)
                if isinstance(node.data, ScanNode):
                    desc.append(("s", node.data.base_table_id, attrs))
                else:
                    j = node.data
                    desc.append((
                        "j", j.build_left, j.left, j.right,
                        j.left_attr, j.right_attr, attrs,
                    ))
            rows = tuple(t.num_rows for t in plan.inputs)
            blob = repr((desc, rows, plan.root)).encode()
            key = hashlib.sha1(blob).hexdigest()
            plan._feedback_key = key
        return key

    def load_into(self, plan: Plan) -> bool:
        """Set ``plan._learned_buckets`` from the store; True on a hit. The
        entry's root row count is not read: the port fetches exactly the
        root's live rows."""
        with self._lock:
            data = self._load_locked()
            hit = data.get(self._key(plan)) if data is not None else None
            if not hit:
                return False
            try:
                buckets, _root_rows = hit
                learned = {int(i): (int(pad), bool(comp))
                           for i, (pad, comp) in buckets.items()}
            except (TypeError, ValueError, AttributeError):
                self.stats["load_errors"] += 1
                return False
            self.stats["loaded"] += 1
        plan._learned_buckets = learned
        return True

    def put(self, plan: Plan, root_rows: int) -> None:
        """Record ``plan._learned_buckets`` and the root's exact row count
        of the run that learned them."""
        buckets = {
            str(i): [int(pad), bool(comp)]
            for i, (pad, comp) in plan._learned_buckets.items()
        }
        entry = [buckets, int(root_rows)]
        key = self._key(plan)
        with self._lock:
            data = self._load_locked()
            if data is not None and data.get(key) != entry:
                data[key] = entry
                self._dirty = True

    def save(self) -> None:
        with self._lock:
            path = self._path
            if not (path and self._dirty):
                return
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                directory = os.path.dirname(path)
                if directory:
                    os.makedirs(directory, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(self._data, f)
                os.replace(tmp, path)
                self._dirty = False
                self.stats["saves"] += 1
            except OSError:
                self.stats["save_errors"] += 1
                try:
                    os.remove(tmp)
                except OSError:
                    pass


_FEEDBACK: Optional[_FeedbackStore] = None
_FEEDBACK_LOCK = threading.Lock()


def _feedback_store() -> _FeedbackStore:
    global _FEEDBACK
    if _FEEDBACK is None:
        with _FEEDBACK_LOCK:
            if _FEEDBACK is None:
                store = _FeedbackStore()
                atexit.register(store.save)
                _FEEDBACK = store
    return _FEEDBACK


def feedback_stats() -> dict:
    """The store's file (None when it is off) and its tallies: plans
    ``loaded`` from it, ``saves``, and files that could not be read
    (``load_errors``) or written (``save_errors``)."""
    store = _feedback_store()
    with store._lock:
        store._load_locked()
        return {"path": store._path, **store.stats}


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
    int64 bit patterns back to FP64. Traced as ``decode.column``."""
    n = len(valid)
    with trace.span("decode.column") as sp:
        sp.note("dtype", dt.name)
        sp.note("rows", n)
        return _decode_values(dt, values, valid, dictionary, n)


def _decode_values(dt: DataType, values: np.ndarray, valid: np.ndarray,
                   dictionary: Optional[StringDict], n: int) -> HostColumn:
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

    An owner's entry goes when the owner dies (a weakref callback). The
    cyclic garbage collector may run that callback on a thread that holds
    the ledger's lock, in the middle of a walk over the entries: there the
    key is queued and dropped at the ledger's next locked entry, and every
    walk goes over a snapshot.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: dict = {}  # id(owner) -> _LedgerEntry
        self._reservations: dict = {}  # token -> bytes
        self._seq = 0
        self._local = threading.local()
        #: owners that died while their thread held the lock: (key, ref)
        self._dead: list = []
        self.stats = trace.Counters(
            "ledger", ("evictions", "evicted_bytes", "waits", "charged_bytes"))

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
            self._drop_dead()
            e = self._entries.get(key)
            if e is None:
                ref = weakref.ref(owner, lambda r, k=key: self._forget(k, r))
                e = self._entries[key] = _LedgerEntry(ref, 0, 0, release)
            e.nbytes += int(nbytes)
            self.stats.add("charged_bytes", int(nbytes))  # cumulative uploads
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
            self._drop_dead()
            e = self._entries.get(key)
            if e is None:
                return False
            self._seq += 1
            e.seq = self._seq
            e.users.update(self._tokens())
            return True

    def _forget(self, key, ref) -> None:
        """The owner of ``key`` died (``ref`` is its entry's weakref)."""
        # Condition._is_owned: whether this thread holds the lock. A
        # callback run there may be inside a walk over the entries, so the
        # key waits for the next locked entry.
        if self._cond._is_owned():
            self._dead.append((key, ref))
            return
        with self._cond:
            self._dead.append((key, ref))
            self._drop_dead()

    def _drop_dead(self) -> None:
        """Drop the entries of owners that died (lock held; called at the
        start of every locked method). An entry is dropped only if it is
        still the dead owner's: its key may belong to a new owner now."""
        while self._dead:
            key, ref = self._dead.pop()
            e = self._entries.get(key)
            if e is not None and e.ref is ref:
                del self._entries[key]

    # -- accounting -------------------------------------------------------

    def pinned_bytes(self) -> int:
        with self._cond:
            self._drop_dead()
            return sum(e.nbytes for e in list(self._entries.values()))

    def _evict_locked(self, need: int, protect: set) -> int:
        """Evict idle LRU entries until ``need`` bytes are freed (or no
        idle entries remain). Returns bytes freed. Lock held."""
        freed = 0
        cand = sorted(
            ((k, e) for k, e in list(self._entries.items())
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
            self.stats.add("evictions")
            self.stats.add("evicted_bytes", e.nbytes)
        if freed:
            _drop_fused_struct_caches()
        return freed

    def evict_idle(self) -> int:
        """Evict every entry not in use by an in-flight query."""
        with self._cond:
            self._drop_dead()
            live = set(self._reservations)
            return self._evict_locked(1 << 62, live)

    def reserve(self, est: int, budget: int, block: bool = True):
        """Admit a query with an ``est``-byte working set under ``budget``.

        Evicts idle cache entries to fit; blocks (when ``block``) until
        concurrent reservations drain if still over; proceeds best-effort
        when running alone. Returns a :class:`_Reservation`, or None when
        ``block=False`` and the query cannot fit next to the current
        in-flight set. Traced as ``ledger.admit`` (the estimate, the waits
        and the bytes evicted)."""
        token = object()
        waits = evicted = 0
        with trace.span("ledger.admit") as sp, self._cond:
            while True:
                self._drop_dead()
                live = set(self._reservations)
                pinned = sum(e.nbytes for e in list(self._entries.values()))
                reserved = sum(self._reservations.values())
                over = pinned + reserved + est - budget
                if over > 0:
                    freed = self._evict_locked(over, live | {token})
                    over -= freed
                    evicted += freed
                if over <= 0 or not self._reservations:
                    break  # fits, or alone: best-effort
                if not block:
                    return None
                self.stats.add("waits")
                waits += 1
                self._cond.wait(timeout=60.0)
            self._reservations[token] = est
            if trace.ON:
                sp.note("estimate", est)
                sp.note("waits", waits)
                sp.note("evicted_bytes", evicted)
        return _Reservation(self, token)

    def release(self, token) -> None:
        with self._cond:
            self._drop_dead()
            self._reservations.pop(token, None)
            for e in list(self._entries.values()):
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
#: packages report the same keys. Keys: ``oom_retries`` (out of memory ->
#: cache-drop retry), ``oom_host_spills`` (retry ladder exhausted ->
#: host-staged), ``admission_host_spills`` (inputs alone exceed the budget).
ENGINE_STATS = trace.Counters("engine", (
    "infra_fallbacks", "oom_retries", "oom_host_spills",
    "admission_host_spills"))
#: query names (plan._name) that degraded, per kind — same keys
ENGINE_STATS_QUERIES: dict = {k: [] for k in ENGINE_STATS}


_ENGINE_STATS_LOCK = threading.Lock()


def engine_stats() -> dict:
    with _ENGINE_STATS_LOCK:
        out = ENGINE_STATS.snapshot()
        out["queries"] = {k: list(v) for k, v in ENGINE_STATS_QUERIES.items()
                          if v}
    return out


def reset_engine_stats() -> None:
    with _ENGINE_STATS_LOCK:
        ENGINE_STATS.reset()
        for names in ENGINE_STATS_QUERIES.values():
            names.clear()


def _tally(kind: str, plan) -> None:
    name = getattr(plan, "_name", None)
    with _ENGINE_STATS_LOCK:
        ENGINE_STATS.add(kind)
        if name is not None:
            ENGINE_STATS_QUERIES[kind].append(str(name))


#: the blocking fetches of every executor (``rounds``) and the bytes they
#: bring to the host
FETCH_STATS = trace.Counters("fetch", ("rounds", "bytes"))
#: the fused executor: structures built (``struct_builds``; 0 in a warm
#: steady state) and attempts re-run after an overflow (``overflow_reruns``)
FUSED_STATS = trace.Counters("fused", ("struct_builds", "overflow_reruns"))
#: the fused executor's root columns encoded into pages on the device before
#: the fetch (``on_card_columns``) and the pages they filled (``on_card_pages``)
ENCODE_STATS = trace.Counters("encode", ("on_card_columns", "on_card_pages"))


def _count_fetch(arrays) -> None:
    """Count one blocking fetch of host ``arrays``."""
    FETCH_STATS.add("rounds")
    FETCH_STATS.add("bytes", sum(a.nbytes for a in arrays))


def _fetched(kind: str, arrays, start_ns: int, end_ns: int):
    """The ``fetch`` span of one fetch the caller timed (``kind`` is
    ``totals`` or ``root``), and for the root's a ``decode`` span opened
    where the fetch ended (None otherwise, and while tracing is off)."""
    if not trace.ON:
        return None
    trace.record("fetch", start_ns, end_ns,
                 {"kind": kind, "bytes": sum(a.nbytes for a in arrays)})
    return trace.open_at("decode", end_ns) if kind == "root" else None


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
    """Blocking fetch of a generator's request (every executor's fetches
    go through here, and are counted)."""
    out = [t.cpu().numpy() for t in tensors]
    _count_fetch(out)
    return out


def _leave_stats(plan: Plan, context: Context, stats: dict) -> None:
    plan._last_exec_stats = stats
    context.last_exec_stats = stats


def _execute_fused(plan: Plan, context: Context) -> Optional[HostTable]:
    """Drive :func:`_fused_attempts` to its end, fetching each request as
    it comes. Returns the decoded root table, or None when the plan cannot
    fuse. Leaves a stage breakdown of this execution (dispatch, fetch and
    decode milliseconds on the host clock, fetch rounds) on the plan and
    the context as ``_last_exec_stats`` / ``last_exec_stats``. The stamps
    that cut the stages also bound the ``fetch`` and ``decode`` spans.
    The joins of the attempt that served the result leave their shapes
    (``node_shapes``) and, on the card, their stream time
    (``node_device_ms``) there too (:func:`_node_stats`)."""
    stats = {"dispatch_ms": 0.0, "fetch_ms": 0.0, "rounds": 0}
    gen = _fused_attempts(plan, context, stats)
    decode = None
    t0 = time.time_ns()
    try:
        kind, req = next(gen)
        while True:
            t1 = time.time_ns()
            stats["dispatch_ms"] += (t1 - t0) / 1e6
            fetched = _fetch(req)
            t0 = time.time_ns()
            stats["fetch_ms"] += (t0 - t1) / 1e6
            stats["rounds"] += 1
            decode = _fetched(kind, fetched, t1, t0)
            kind, req = gen.send(fetched)
    except StopIteration as stop:
        t1 = time.time_ns()
        trace.close(decode, t1)
        stats["decode_ms"] = (t1 - t0) / 1e6
        _leave_stats(plan, context, stats)
        return stop.value


def _feedback_state(plan: Plan):
    """``(feedback_on, learned, buckets)``: the cardinality feedback a fused
    run of ``plan`` starts from. A plan object that has learned nothing yet
    is looked up in the cross-process store first. General joins whose
    learned bucket was compacted seed ``buckets`` with it."""
    from .plan import executor as _exec

    feedback_on = _exec.card_feedback_on()
    if feedback_on and not hasattr(plan, "_learned_buckets"):
        _feedback_store().load_into(plan)
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    buckets: dict = {}
    if learned:
        for i, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(i, pad)
    return feedback_on, learned, buckets


def _struct_state_key(device, buckets: dict, learned, no_compact) -> tuple:
    """The key a fused structure is cached under on its plan
    (``plan._fused_struct_cache``): the device, the strategy knobs (a
    structure built under other knob values must not be served), the
    buckets, the learned feedback and the joins not compacted."""
    from .plan import executor as _exec

    return (
        device,
        _exec.strategy_knobs(),
        tuple(sorted(buckets.items())),
        tuple(sorted(learned.items())) if learned else None,
        frozenset(no_compact),
    )


def precompile_fused(plan: Plan, context: Optional[Context] = None) -> bool:
    """Prepare the plan's first fused execution without running it.

    Registers the plan, loads its cardinality feedback (from the
    cross-process store when the plan object has none), resolves and
    uploads its scan columns and indexes inside a ledger reservation of
    their bytes, and caches the structure under the key that
    :func:`execute`'s first attempt looks up, so that execute reuses it
    (after ``revalidate()``) and builds none. On a CUDA context it ends by
    loading the kernel libraries (``ops.kernels.build``), so the first
    execute pays neither ``nvcc`` nor ``dlopen``. Safe to call from many
    threads at once.

    Returns False, and caches nothing, for a plan the fused executor does
    not take: a VARCHAR key the structure declines, or scan inputs over
    the device budget (``execute`` spills those). Raises where ``execute``
    would (a malformed plan, no card for the default context)."""
    from .ops import kernels
    from .plan import fused as fz

    if context is None:
        context = build_context()
    device = context.device
    plan.validate()
    budget = _hbm_budget(context)
    scan_bytes = _estimate_scan_bytes(plan)
    if scan_bytes > budget:
        return False
    register_device_cache_plan(plan)
    unique_joins = _detect_unique_joins(plan)
    _feedback_on, learned, buckets = _feedback_state(plan)
    with device_ledger(device).reserve(scan_bytes, budget):
        FUSED_STATS.add("struct_builds")
        structure = fz.FusedPlan(plan, buckets, unique_joins, device,
                                 learned, frozenset())
        if structure.has_varchar_key:
            return False
        plan._fused_struct_cache = (
            _struct_state_key(device, buckets, learned, ()), structure)
    if device.type == "cuda":
        kernels.build()
    return True


def _fused_attempts(plan: Plan, context: Context,
                    stats: Optional[dict] = None):
    """Generator form of the fused executor: yields its fetch requests as
    ``(kind, tensors)``, ``kind`` ``"totals"`` or ``"root"``, takes the
    fetched numpy values sent back in, and returns the decoded HostTable
    (or None when the plan cannot fuse). Separating dispatch from fetch
    lets :func:`execute_many` dispatch many plans before it consumes any
    result.

    Per attempt: build (or revalidate and reuse) the structure for the
    current bucket state, run it, and ask for the per-join totals. A
    general join whose total exceeded its bucket re-runs with the exact
    bucket; joins above an overflowed join are not trustworthy and double
    their bucket; a probe-shaped join compacted to a stale learned pad
    re-runs uncompacted. On success the exact buckets are kept on the plan
    object as cardinality feedback for its next execution, and the root's
    live rows (``[:root_total]``, exact) are asked for: each fixed-width
    column as row-aligned pages encoded on the device
    (:func:`_encode_root_pages`), which the returned table holds as a paged
    ``Column``, and each VARCHAR column as ids and validity, decoded. The
    exact buckets go to the cross-process store too (:class:`_FeedbackStore`),
    and a plan object with none is looked up there first. The exact
    attempt's joins are counted by rows (:func:`_node_stats`), which also
    fills ``stats`` where one is given.

    Traced: ``prepare`` (before the first attempt), then per attempt
    ``fused.attempt`` over ``fused.build``, ``fused.launch`` and
    ``fused.check``, then an ``encode.column`` a fixed-width root column
    (``on_card`` true)."""
    from .plan import fused as fz

    trace.note_request("route", "fused")
    with trace.span("prepare"):
        register_device_cache_plan(plan)
        device = context.device
        root_node = plan.nodes[plan.root]
        unique_joins = _detect_unique_joins(plan)
        feedback_on, learned, buckets = _feedback_state(plan)
        no_compact: set = set()
    for attempt in range(len(plan.nodes) + 2):
        with trace.span("fused.attempt") as att:
            att.note("attempt", attempt)
            with trace.span("fused.build") as sp:
                state_key = _struct_state_key(device, buckets, learned,
                                              no_compact)
                cached = getattr(plan, "_fused_struct_cache", None)
                built = not (
                    cached is not None
                    and cached[0] == state_key
                    and cached[1].revalidate()
                )
                if built:
                    FUSED_STATS.add("struct_builds")
                    structure = fz.FusedPlan(
                        plan, buckets, unique_joins, device, learned,
                        frozenset(no_compact),
                    )
                    plan._fused_struct_cache = (state_key, structure)
                else:
                    structure = cached[1]
                sp.note("built", built)
            if structure.has_varchar_key:
                return None  # the caller falls back to the wave executor
            with trace.span("fused.launch"):
                (out_values_dev, out_valid_dev, totals_dev,
                 marks) = fz.run(structure)
            (totals,) = yield "totals", [totals_dev]

            with trace.span("fused.check"):
                overflow = _check_totals(structure, totals, buckets,
                                         no_compact)
                if not overflow:
                    root_total = _root_total(plan, structure, totals)
                    _keep_feedback(plan, structure, totals, root_total,
                                   feedback_on)
                    _node_stats(plan, structure, marks, totals, stats)
            att.note("overflowed", overflow)
        if overflow:
            FUSED_STATS.add("overflow_reruns")
            del out_values_dev, out_valid_dev  # free before the re-run
            continue

        # bounded root fetch: only the live rows cross to the host, the
        # fixed-width columns as pages encoded here, VARCHAR as ids
        attrs = root_node.output_attrs
        values, valids = list(out_values_dev), list(out_valid_dev)
        del out_values_dev, out_valid_dev
        pages = _encode_root_pages(values, valids, root_total, attrs)
        request = []
        for ko in range(len(attrs)):
            request += ([pages[ko]] if ko in pages else
                        [values[ko][:root_total], valids[ko][:root_total]])
        fetched = iter((yield "root", request))

        sources = structure.col_sources[plan.root]
        cols = [
            Column(dt, next(fetched)) if ko in pages else
            _decode_host_column(dt, next(fetched), next(fetched),
                                structure.dicts[sources[ko]])
            for ko, (_ci, dt) in enumerate(attrs)
        ]
        return HostTable(root_total, cols)
    raise RuntimeError("fused plan did not converge to exact buckets")


def _encode_root_pages(values: list, valids: list, root_total: int,
                       attrs) -> dict:
    """The root's fixed-width columns as row-aligned pages on the device
    (``kernels.encode_pages_aligned``), by output column. One column at a
    time: each column's padded values and validity are dropped from
    ``values`` / ``valids`` once its pages are launched, so the pages of
    the next take their place. Each is traced as an ``encode.column`` span
    with ``on_card`` true, and counted (:data:`ENCODE_STATS`)."""
    out = {}
    for ko, (_ci, dt) in enumerate(attrs):
        if dt is DataType.VARCHAR:
            continue
        with trace.span("encode.column") as sp:
            (col_pages,) = kernels.encode_pages_aligned(
                [values[ko]], [valids[ko]], root_total, [dt])
            values[ko] = valids[ko] = None
            if trace.ON:
                sp.note("dtype", dt.name)
                sp.note("rows", root_total)
                sp.note("pages", col_pages.shape[0])
                sp.note("on_card", True)
        ENCODE_STATS.add("on_card_columns")
        ENCODE_STATS.add("on_card_pages", col_pages.shape[0])
        out[ko] = col_pages
    return out


def _check_totals(structure, totals, buckets: dict, no_compact: set) -> bool:
    """Exactness of one attempt's per-join totals; True when a join
    overflowed and the plan runs again. A join's total is trustworthy iff
    no descendant general join overflowed its bucket; probe-shaped
    strategies cannot overflow. Sets ``buckets`` (and ``no_compact``) for
    the next attempt or execution."""
    exact: dict = {}
    overflow = False
    for ji, node_id in enumerate(structure.join_order):
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
    return overflow


def _node_stats(plan: Plan, structure, marks, totals,
                stats: Optional[dict]) -> None:
    """The joins of an exact fused run (``marks``, as :func:`fused.run
    <radixjoin_tpu_torch.plan.fused.run>` returned them), once its totals
    are on the host: each counted by its live probe and output rows, by strategy
    (``join.probe_rows.<strategy>``, ``join.out_rows.<strategy>``), and
    left in ``stats`` (when given) as ``node_shapes``, node id ->
    ``{strategy, probe_rows, build_rows, key_bytes, out_rows,
    out_col_bytes}`` (live rows, not padded ones; bytes of one value),
    and on the card ``node_device_ms``, node id -> milliseconds between
    the node's two events: its stream time, the launch gaps inside it
    included. That time is also the ``device_ms`` of its ``fused.node``
    span. The totals' fetch has waited for the run's stream, so reading
    the events blocks on nothing."""
    from .plan import fused as fz

    live = {node_id: int(totals[ji])
            for ji, node_id in enumerate(structure.join_order)}

    def rows(child: int) -> int:
        if child in live:
            return live[child]
        return plan.inputs[plan.nodes[child].data.base_table_id].num_rows

    shapes, device_ms = {}, {}
    for mark in marks:
        spec = structure.join_specs[mark.node]
        build, probe = ((spec.left, spec.right) if spec.build_left
                        else (spec.right, spec.left))
        shape = {"strategy": spec.strategy, "probe_rows": rows(probe),
                 "build_rows": rows(build), "key_bytes": mark.key_bytes,
                 "out_rows": live[mark.node],
                 "out_col_bytes": list(mark.out_col_bytes)}
        shapes[mark.node] = shape
        fz.JOIN_STATS.add(f"probe_rows.{spec.strategy}", shape["probe_rows"])
        fz.JOIN_STATS.add(f"out_rows.{spec.strategy}", shape["out_rows"])
        if mark.start is not None:
            ms = mark.start.elapsed_time(mark.end)
            device_ms[mark.node] = ms
            mark.span.note("device_ms", ms)
    if stats is not None:
        stats["node_shapes"] = shapes
        if device_ms:
            stats["node_device_ms"] = device_ms


def _root_total(plan: Plan, structure, totals) -> int:
    root_node = plan.nodes[plan.root]
    if isinstance(root_node.data, ScanNode):
        return plan.inputs[root_node.data.base_table_id].num_rows
    return int(totals[structure.join_order.index(plan.root)])


def _keep_feedback(plan: Plan, structure, totals, root_total: int,
                   feedback_on: bool) -> None:
    """Keep an exact run's per-join totals on the plan and, with feedback
    on, its exact buckets (in the cross-process store too)."""
    join_order = structure.join_order
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
        _feedback_store().put(plan, root_total)


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
                              context: Context) -> HostTable:
    """Spill executor: tables stay on the host; every join streams hash
    partitions through the context's device pair by pair (ops/radix.py),
    and materialization is a host-side ``take`` at the surviving row pairs.

    This is the multi-pass generalization of the reference's single L2
    radix pass (src/execute.cpp:86-92) to the split between host memory
    and device memory. ``plan._last_spill_partitions`` keeps the partition
    count of each join of the last run. Leaves ``_last_exec_stats`` as the
    fused executor does: ``fetch_ms`` and ``rounds`` of the pairs' index
    fetches, ``decode_ms`` the host takes that materialize every join,
    ``dispatch_ms`` the rest. Traced as ``spill``, with each pair's
    ``upload`` and ``fetch`` beneath it."""
    from .ops import radix

    device = context.device
    stats = {"dispatch_ms": 0.0, "fetch_ms": 0.0, "rounds": 0,
             "decode_ms": 0.0}

    def fetch(tensors):
        t0 = time.time_ns()
        out = _fetch(tensors)
        t1 = time.time_ns()
        stats["fetch_ms"] += (t1 - t0) / 1e6
        stats["rounds"] += 1
        _fetched("pairs", out, t0, t1)
        return out

    with trace.span("spill"):
        t_start = time.time_ns()
        host = _spill_joins(plan, budget_bytes, device, radix, fetch, stats)
        stats["dispatch_ms"] = ((time.time_ns() - t_start) / 1e6
                                - stats["fetch_ms"] - stats["decode_ms"])
    _leave_stats(plan, context, stats)
    return host


def _spill_joins(plan: Plan, budget_bytes, device, radix, fetch,
                 stats: dict) -> HostTable:
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
            kb, vb, kp, vp, num_partitions=partitions[idx], device=device,
            fetch=fetch,
        )
        lidx = bidx if j.build_left else pidx
        ridx = pidx if j.build_left else bidx
        left_w = len(left.columns)
        cols = []
        t0 = time.time_ns()
        for ci, dt in node.output_attrs:
            src, sel = (left.columns[ci], lidx) if ci < left_w else (
                right.columns[ci - left_w], ridx
            )
            cols.append(src.take(sel))
        stats["decode_ms"] += (time.time_ns() - t0) / 1e6
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
    (:func:`engine_stats`). Traced as one ``request`` (its attribute
    ``route`` the executor that gave the result)."""
    if context is None:
        context = build_context()
    with trace.request(plan):
        return _execute(plan, context)


def _execute(plan: Plan, context: Context) -> ColumnarTable:
    with trace.span("prepare"):
        plan.validate()
        budget = _hbm_budget(context)
        mode = _exec_mode()
        ledger = device_ledger(context.device)
        spill = _estimate_scan_bytes(plan) > budget
        if not spill:
            est = min(_estimate_query_bytes(plan), budget)

    if spill:
        # the inputs alone exceed the budget: host-staged multi-pass radix
        _tally("admission_host_spills", plan)
        ledger.evict_idle()
        trace.note_request("route", "spill")
        return _encode_result(
            _execute_host_partitioned(plan, budget // 8, context))

    with ledger.reserve(est, budget):
        host = None
        for attempt in range(3):
            try:
                host = _run_on_device(plan, context, mode)
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
            with trace.span("oom.retry"):
                clear_device_caches()
        if host is None:
            # the query alone does not fit: stream it through the
            # host-staged multi-pass radix executor
            trace.note_request("route", "spill")
            host = _execute_host_partitioned(plan, budget // 8, context)
    return _encode_result(host)


def _run_on_device(plan: Plan, context: Context, mode: str) -> HostTable:
    """The device executors in turn: fused, then wave, then stepwise."""
    from .plan import executor

    host = None
    if mode in ("auto", "fused"):
        host = _execute_fused(plan, context)
    if host is None and mode != "stepwise":
        # shared mode, or the fused structure declined the plan (a
        # VARCHAR key it cannot window): the wave executor unifies the
        # dictionaries itself
        trace.note_request("route", "wave")
        host = executor.execute_shared(
            plan, _detect_unique_joins(plan), context.device)
        context.last_exec_stats = plan._last_exec_stats
    if host is None:
        trace.note_request("route", "stepwise")
        host = _execute_stepwise(plan, context)
    return host


def _execute_stepwise(plan: Plan, context: Context) -> HostTable:
    """The stepwise executor (:func:`execute_device`), then the root's live
    rows in one fetch and their decode. Leaves ``_last_exec_stats`` as the
    fused executor does (its joins' own host syncs fall under dispatch).
    Traced as ``stepwise``."""
    with trace.span("stepwise"):
        t0 = time.time_ns()
        table = execute_device(plan, context)
        n, k = table.num_rows, len(table.columns)
        t1 = time.time_ns()
        fetched = _fetch([c.data[:n] for c in table.columns]
                         + [c.valid[:n] for c in table.columns])
        t2 = time.time_ns()
        decode = _fetched("root", fetched, t1, t2)
        cols = [_decode_host_column(c.dtype, fetched[i], fetched[k + i],
                                    c.dictionary)
                for i, c in enumerate(table.columns)]
        t3 = time.time_ns()
        trace.close(decode, t3)
    _leave_stats(plan, context, {
        "dispatch_ms": (t1 - t0) / 1e6, "fetch_ms": (t2 - t1) / 1e6,
        "rounds": 1, "decode_ms": (t3 - t2) / 1e6})
    return HostTable(n, cols)


def _encode_result(host: HostTable) -> ColumnarTable:
    """HostTable -> paged ColumnarTable (the reference's final
    to_columnar step, src/execute.cpp:322-323). A column that arrives as
    a paged ``Column`` (the fused executor's fixed-width root columns,
    encoded on the device) is taken as it is; the others are encoded
    here, traced as ``encode``, a ``encode.column`` a column."""
    cols = []
    with trace.span("encode"):
        for c in host.columns:
            if isinstance(c, Column):
                cols.append(c)
                continue
            with trace.span("encode.column") as sp:
                if c.dtype is DataType.VARCHAR:
                    pages = page_codec.encode_varchar_heap(c.heap, c.ends,
                                                           c.valid)
                else:
                    pages = page_codec.encode_fixed(c.values, c.valid,
                                                    c.dtype)
                if trace.ON:
                    sp.note("dtype", c.dtype.name)
                    sp.note("rows", len(c.valid))
                    sp.note("pages", len(pages))
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
        out = [h.numpy() for h in self._host]
        _count_fetch(out)
        return out


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

    Traced as one ``request`` a plan, from the start of the call to the
    plan's result; each plan's steps, fetch waits and fallback run with
    its request current.
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
    live: dict = {}  # idx -> (generator, request kind, pending fetch)
    tokens: dict = {}  # idx -> ledger reservation
    streams: dict = {}  # idx -> the plan's CUDA stream (None on the CPU)
    fallbacks: List[int] = []
    #: idx -> the plan's trace request (None while tracing is off)
    reqs = {idx: trace.begin_request(plan) for idx, plan in enumerate(plans)}

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
            trace.end_request(reqs[idx], True)

    def _step(idx: int, gen, fetched, decode=None) -> None:
        """Advance one plan's generator by one step, on the plan's stream
        and under its ledger token and trace request: to its next fetch
        request (whose copies are started at once) or to its end."""
        stream = streams[idx]
        oom = False
        try:
            with ledger.activate(tokens[idx].token), trace.activate(reqs[idx]):
                if stream is None:
                    kind, req = gen.send(fetched)
                else:
                    with torch.cuda.stream(stream):
                        kind, req = gen.send(fetched)
        except StopIteration as stop:
            trace.close(decode)
            with trace.activate(reqs[idx]):
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
        live[idx] = (gen, kind, _PendingFetch(req, stream))

    def _try_start(idx: int) -> bool:
        """Admit + dispatch one plan; False = does not fit next to the
        in-flight set right now (the caller retries after a drain round)."""
        plan = plans[idx]
        est = min(_estimate_query_bytes(plan), budget)
        with trace.activate(reqs[idx]):
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

    def _consume(idx: int) -> None:
        """Wait for one plan's pending fetch and take its next step."""
        gen, kind, pending = live.pop(idx)
        with trace.activate(reqs[idx]):
            t0 = trace.now()
            fetched = pending.wait()
            decode = _fetched(kind, fetched, t0, trace.now())
        _step(idx, gen, fetched, decode)

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
                _consume(idx)
            # freed reservations admit deferred plans for the next round
            deferred = [idx for idx in deferred if not _try_start(idx)]
        # Serial fallbacks (declined, over-budget or out-of-memory plans)
        # run once nothing is in flight: ``execute`` reserves with
        # ``block=True``, and on this thread no reservation of the batch
        # would ever drain.
        for idx in fallbacks:
            with trace.activate(reqs[idx]):
                results[idx] = _execute(plans[idx], context)
            trace.end_request(reqs[idx], True)
    finally:
        # a plan that raised leaves the others' reservations behind
        for idx in list(tokens):
            _release(idx)
        for idx, req in reqs.items():
            if results[idx] is None:
                trace.end_request(req, False)
    if on_card:
        # later work on the caller's stream sees every plan's stream done
        for stream in streams.values():
            torch.cuda.current_stream(device).wait_stream(stream)
    return results
