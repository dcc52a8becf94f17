"""Smoke run of radixjoin_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--scale 0.1] [--seed 0]
    python3 chip_smoke.py --kernels OTHER/radixjoin_tpu_torch/ops/kernels.py

Phases (any failure exits non-zero; the last line of standard output is
``{"ok": true, "device": {...}}`` only when every phase passed):

1. Environment and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernels from
   ``radixjoin_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per source,
   all at once (seconds, ptxas' register and shared-memory report).
2. Kernel checks: each kernel against its plain PyTorch version on the card,
   on the same inputs, bit-equal, with the median time of warm runs of
   both (per call, over brackets of five calls back to back): the join
   kernels at main-path shapes, the gather-experiment kernels at the
   tools' default shapes (n = 2^24, window 2^20, one-hot window 2048),
   with the route (shared memory or L2) each case took.
   Beside them, for each case: its bound, the bytes the function must
   move (each input read once, each output written once) over the
   published 3,350 GB/s — every one of the seven is a gather, a function
   with no arithmetic, so bytes bound them all — and ``library_ms``, the
   time of the bare PyTorch call that gives the same values
   (``index_select`` or ``gather`` on an index widened beforehand) — a
   yardstick only, the package never calls it. The two join gathers also
   run with mixed element sizes in one call, unaligned table and index
   views, ragged lengths and tables past the shared-memory budget, and
   ``blocked_window_gather_multi`` also as the join calls it, without
   its flags (``with_ok=False``). ``paged_window_gather`` runs at the
   decode's page counts (131, 1,900 and 18,878: S1's ``title`` and
   ``cast_info`` at scale 0.1, ``cast_info`` at 1.0), each case also with
   its route and the device time ``torch.profiler`` records for the kernel
   and for ``gather``, at 1,900 pages also with the L2 flushed before every
   call; then on its scalar route (views one word off 16 bytes) and with
   indices outside the page; then the whole ``decode_fixed_device`` of an
   INT32 and an INT64 column at 1,900 and 18,878 pages, with the kernel's
   share of its device time.
   The resident gathers also run with unaligned index and table views,
   with one tile, and with sequential positions on the L2 route (the
   index and output streams alone: what remains of the random-position
   time is the price of the random 32-byte sectors); ``onehot_gather``
   with indices outside the table, a table length that is no multiple of
   4, a table view at an odd offset and values over its whole domain.
3. Main path: the synthetic IMDB at ``--scale`` (default 0.1, the
   repository bench's scale) and ``--seed``, three JOB-shaped plans
   (radixjoin_tpu_torch/harness/job_shapes.py) — S1 from eager pages
   (device page decode), S2 lazily (dense upload), S3 with a combined pad
   of 2^23 at the root (the merge join) — and F1, a join on FP64 keys
   (merge join). Each runs cold and warm through ``execute`` on the card,
   with the kernels' launch counters set to 0 just before and read just
   after, then once through ``build_context("cpu")``, where the plain
   versions serve as the oracle. Checked: equal per-join totals, equal
   row multisets, the root cardinality against a numpy count over the
   base tables, the join strategies covered (merge included), and a
   launch count above 0 for every kernel of the path.
4. Device-time path: with the counters set to 0 just before, every case
   of ``harness/devtime.py`` at ``--devtime-size`` rows (default 2^22),
   printed with its ms and share of the HBM figure, then the kernel cases
   of the three gather-experiment tools (``radixjoin_tpu_torch/tools``)
   at their default shapes; the counters are read just after, and every
   kernel of the path must have launched.

5. Memory and batch, on the card, over phase 3's plans and data, with the
   counters set to 0 just before and read just after:
   a. S1 and F1 on the stepwise executor (``RJT_EXEC_MODE=stepwise``):
      rows equal to phase 3's, the blocked-window and paged-decode kernels
      launched;
   b. S2 under a budget of a quarter of its scan bytes: ``execute`` takes
      the host-staged radix spill and streams more than one partition
      pair through the card; rows equal to phase 3's and the numpy count,
      ``admission_host_spills == 1``, at least one blocked-window launch
      per joined partition pair;
   c. S1, S3, S1 under a budget that holds either alone but not the
      uploads of both: evictions fire, results stay equal, the pinned
      bytes stay under the budget, and after ``clear_device_caches()``
      ``torch.cuda.memory_allocated()`` is back within 1 MiB of its value
      at the start of the phase (a release dropped every reference);
   d. ``execute_many`` over the four plans twice, under the default budget
      and under one that defers plans: each result equals the serial one
      in input order, no degradation tally rose; batch ms against the sum
      of phase 3's serial warm ms, and the peak device memory;
   e. one plan whose first fused run is made to raise
      ``torch.cuda.OutOfMemoryError`` (from here; the package has no such
      switch): ``oom_retries == 1``, result equal.

6. The wave executor, the strategy knobs and the SQL entry point, on the
   card, with the counters set to 0 just before and read just after:
   a. S1, S2, S3 and F1 under ``RJT_EXEC_MODE=shared``, on fresh plan
      objects over phase 3's tables, cold and warm: rows and per-join
      totals equal to phase 3's fused results; per plan the ms beside the
      fused warm ms, the shrink syncs and fetch rounds, the host syncs that
      torch's sync debug mode saw in the warm run beside the tensors the
      executor fetched, the ``path_stats()`` and ``sync_stats()`` deltas
      and the peak device memory; all three engine kernels launched;
   b. the VARCHAR-key query document in ``auto`` mode with the fused
      lowering made to decline (from here): served by ``execute_shared``,
      rows equal to the oracles';
   c. the query documents of ``harness/job_shapes.py`` written to a
      temporary directory and run through ``JobHarness`` over the
      query-aware synthetic IMDB (filters applied by
      ``ingest.filter_table``), with lazy inputs and with
      ``RJT_EAGER_PAGES=on``: every result non-empty and equal to sqlite on
      the rewritten SQL and to the same query on ``build_context("cpu")``;
      equal to the row-by-row plan oracle where the plan's inputs hold
      fewer than a million rows, and all of them again, through
      ``verify_result`` (both oracles), at a tenth of the scale; the JOB
      6a-shaped document on the wave executor under
      ``RJT_SHRINK_MAX_SYNCS=2`` with the shrink's copy on and off (peak
      device memory of both);
   d. each knob against its default on S2 and S3 (``RJT_CSR_JOIN=off``,
      ``RJT_DEV_CSR=off``, ``RJT_UNIQUE_JOIN=sort``, ``RJT_BIG_MERGE`` at
      2^21 and 2^30, ``RJT_CARD_FEEDBACK=off``): rows equal, the
      strategies the structure took, warm ms.

7. The distributed layer (``radixjoin_tpu_torch/parallel``), with the
   counters set to 0 just before and read just after:
   a. a one-rank NCCL group (``multihost.init`` over a free localhost
      port): S1, S2, S3 and F1 through ``execute_distributed`` over phase
      3's tables, cold, then warm on a fresh plan object of the same
      content: rows equal to phase 3's fused results; per plan the ms
      beside phase 3's fused warm ms, the joins replayed warm, the host
      syncs torch's sync debug mode saw (warm: the root's check and gather
      only), the collective calls and the bytes they moved, and the kernel
      launches; S2 again with ``exchange_chunks=3`` and with
      ``bloom_max_bits=0``; the scenarios of
      ``tools/multihost_worker.py`` against the row oracle;
   b. ``distributed_join`` at 2^22 build and 2^24 probe rows (int64 keys,
      one key on 60% of the probe side), monolithic and with
      ``exchange_chunks=3``: every matched probe row once (numpy), 2^16
      sampled output rows equal to numpy, ``info``, the ms of the whole
      call and of the join on shards already uploaded, peak device memory;
      then the group is left;
   c. two rank processes of ``tools/multihost_worker.py`` on ``cuda:0``
      over gloo: every scenario cold and warm equal on both ranks, row for
      row, and to 7a's one rank as row multisets;
   d. ``q1a`` and ``q_varchar`` through ``JobHarness.run_query`` with
      ``distributed`` on (the harness opens and leaves its own one-rank
      NCCL group), over phase 6's data, against sqlite and the row oracle.

8. The tools a user runs, on the card:
   a. the bench (``python -m radixjoin_tpu_torch.bench``) as a subprocess
      over the query documents (``BENCH_PLANS=builtin``) at ``--scale``
      with its defaults (two passes, device ms, batch, the sf0.01
      secondary pass): one JSON line whose result rows equal the rows 6c
      verified against sqlite for the same documents, every degradation
      tally zero and every bonus stage reported, and rows 1 and 2
      (``window_gather``, ``blocked_window_gather_multi``) launched in
      its warm-up and timed passes (the bench's ``detail.launches``); its
      total, per-query best, batch wall, stage split and device ms logged;
   b. the fuzz campaign (``tools/fuzz_campaign.py``) in this process:
      seeds 0-255 in all six modes (auto, shared, stepwise, spill, dist,
      dist_chunked; the distributed ones cold and warm on a one-rank NCCL
      group), each run held to the row oracle;
   c. the roofline harness (``harness/roofline.py``) at 2^22 probe rows:
      device ms (devtime's slope), rows/s and share of 3,350 GB/s a case;
   d. ``tools/scaling_bench.py --ndev 1`` (NCCL) in join mode with
      ``--breakdown``, and the worker's ``bench_join`` on a one-rank NCCL
      group and on two gloo ranks sharing ``cuda:0``: result rows equal to
      numpy; each reports rank 0's kernel launches in its record.

Before the last line it prints one JSON object with a record per kernel:
``{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
"pct_of_bound", "launches_memory_batch", "launches_shared_sql",
"launches_dist", "launches_bench", "launches_fuzz", "launches_roofline",
"launches_scaling", "launches_tools"}, ...]}`` (``launches`` counts phase
3 for the engine's three kernels and phase 4 for the others;
``launches_memory_batch`` counts phase 5, ``launches_shared_sql`` phase 6,
``launches_dist`` phase 7; ``launches_bench`` counts 8a's warm-up and
timed passes, ``launches_fuzz`` 8b, ``launches_roofline`` 8c (wrapper
calls: a CUDA graph's replay launches again uncounted),
``launches_scaling`` rank 0 of each 8d cluster, and ``launches_tools``
is their sum, the whole of phase 8).

With ``--kernels``, only the page gather's decode cases of phase 2 run, to
compare two builds of ``paged_window_gather`` on one card: this
checkout's wrapper and that of another checkout's ``ops/kernels.py``
(built from that checkout's sources, for example a parent commit
unpacked with ``git archive``), each held equal to the plain version and
timed in turns other, this, this, other, then ``gather``: event bracket,
host ms to issue a call, profiler device ms, and device ms with the L2
flushed before every call. It prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: published device-memory rate of the H100 SXM (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

#: (pages, rows a page) of the device page decode's calls to
#: paged_window_gather: S1's title at scale 0.1, cast_info at 0.1 (INT32
#: and INT64) and cast_info at 1.0 (36,244,344 rows)
PAGED_CASES = ((131, 1920), (1900, 1920), (1900, 960), (18878, 1920))


def _paged_label(npages: int, rows: int) -> str:
    return f"{npages} pages " + ("INT32 R=1920" if rows == 1920
                                 else "INT64 2x960 words")


def _decode_inputs(torch, npages: int, rows: int, seed: int, dev):
    """``(body, idx)`` of a decode's call over ``npages`` pages of ``rows``
    rows, made on ``dev`` from ``seed``: random 2048-word bodies, 80% of
    rows valid, rank the in-page exclusive count of valid rows; the word
    1 + rank of an INT32 row (1920 a page), the words 2 + 2 rank and
    3 + 2 rank of an INT64 row (960 a page)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    body = torch.randint(-(2 ** 31), 2 ** 31, (npages, 2048), generator=gen,
                         device=dev, dtype=torch.int32)
    bits = (torch.rand((npages, rows), generator=gen, device=dev)
            < 0.8).to(torch.int32)
    rank = torch.cumsum(bits, dim=1, dtype=torch.int32) - bits
    idx = (1 + rank if rows == 1920 else
           torch.cat([2 + 2 * rank, 3 + 2 * rank], dim=1))
    return body, idx.contiguous()


def _flat(x) -> list:
    """A kernel's outputs (tensor, list, or (list, tensor)) as one list."""
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flat(e)]
    return [x]


def _max_abs_err(torch, got, want) -> float:
    if got.dtype == torch.bool:
        got, want = got.to(torch.int8), want.to(torch.int8)
    if got.shape != want.shape:
        return float("inf")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, kernels, dev, seed: int):
    """Run every kernel case; returns {kernel name: record} with the
    representative case's times and the worst error over all cases."""
    from radixjoin_tpu_torch.harness.kernel_timing import (bracket_ms,
                                                           device_ms,
                                                           enqueue_ms,
                                                           l2_flusher)

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_table(n, dtype):
        lo, hi = (-(2 ** 31), 2 ** 31) if dtype == torch.int32 else (-(2 ** 62), 2 ** 62)
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    records = {}

    def case(name, label, fn_kernel, fn_plain, representative=False,
             fn_library=None, nbytes=0):
        """One kernel case: bit-equality with the plain version, then the
        times. ``fn_library`` is the bare PyTorch call of the same values
        (checked equal too), ``nbytes`` the least bytes the function moves
        on these inputs; a case with ``nbytes`` prints its bound."""
        got, want = _flat(fn_kernel()), _flat(fn_plain())
        torch.cuda.synchronize()
        route = getattr(getattr(kernels, name), "last_route", None)
        if route:
            label = f"{label} route={route}"
        err = max(_max_abs_err(torch, g, w) for g, w in zip(got, want))
        if len(got) != len(want) or err != 0.0:
            _fail(f"{name} [{label}] disagrees with its plain version "
                  f"(max abs err {err})")
        ms = bracket_ms(fn_kernel)
        plain_ms = bracket_ms(fn_plain)
        line = (f"kernel {name} [{label}]: bit-equal, kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
        library_ms = None
        if fn_library is not None:
            lib = _flat(fn_library())
            if not all(torch.equal(g, w) for g, w in zip(got, lib)):
                _fail(f"{name} [{label}]: the library call disagrees")
            library_ms = bracket_ms(fn_library)
            line += f", library {library_ms:.4f} ms"
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if nbytes:
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            line += (f"; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), "
                     f"kernel at {100.0 * bound_ms / ms:.1f}% of it")
        if representative:
            rec.update(ms=ms, plain_ms=plain_ms, shape=label,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_bytes=nbytes,
                       pct_of_bound=100.0 * bound_ms / ms)
        _log(line)
        return ms

    def paged_device_times(label, fn_kernel, fn_library=None, flush=None):
        """The host time to issue a paged case's kernel call, and the device
        time of the kernel and of gather from torch.profiler; with
        ``flush``, also with the L2 flushed."""
        parts = [f"host to issue a kernel call {enqueue_ms(fn_kernel):.4f} ms"]
        for who, fn in (("kernel", fn_kernel), ("gather", fn_library)):
            if fn is None:
                continue
            for tag, between in (("", None), (" L2 flushed", flush)):
                if tag and between is None:
                    continue
                ms = device_ms(fn, between=between)
                parts.append(f"{who}{tag} "
                             + (f"{ms:.4f} ms" if ms else "not measured"))
        _log(f"kernel paged_window_gather [{label}]: "
             + ", ".join(parts) + " (device times from torch.profiler)")

    def esize(tables):
        return sum(t.element_size() for t in tables)

    def wg_case(label, tabs, idx, representative=False):
        i64 = idx.long()
        n, w = idx.shape[0], tabs[0].shape[0]
        case("window_gather", label,
             lambda: kernels.window_gather(tabs, idx),
             lambda: kernels.window_gather_plain(tabs, idx),
             representative,
             fn_library=lambda: [t.index_select(0, i64) for t in tabs],
             nbytes=n * 4 + (n + w) * esize(tabs))

    def bwg_case(label, tabs, idx, representative=False, with_ok=True):
        # the library call gives the values only; ``ok`` has no library call.
        # ``with_ok=False`` is how the join calls the kernel: no flags are
        # written, and the bound drops their 4 bytes per row
        i64 = idx.long()
        n = idx.shape[0]
        distinct = torch.unique(idx)
        touched = sum(int((distinct < t.shape[0]).sum()) * t.element_size()
                      for t in tabs)
        in_range = all(int(idx.max()) < t.shape[0] for t in tabs)
        library = ((lambda: [t.index_select(0, i64) for t in tabs])
                   if in_range else None)
        if with_ok:
            case("blocked_window_gather_multi", label,
                 lambda: kernels.blocked_window_gather_multi(tabs, idx),
                 lambda: kernels.blocked_window_gather_multi_plain(tabs, idx),
                 representative, fn_library=library,
                 nbytes=n * (4 + esize(tabs) + 4) + touched)
            return
        if kernels.blocked_window_gather_multi(tabs, idx,
                                               with_ok=False)[1] is not None:
            _fail("blocked_window_gather_multi: with_ok=False returned flags")
        case("blocked_window_gather_multi", f"{label} with_ok=False",
             lambda: kernels.blocked_window_gather_multi(tabs, idx,
                                                         with_ok=False)[0],
             lambda: kernels.blocked_window_gather_multi_plain(tabs, idx)[0],
             fn_library=library, nbytes=n * (4 + esize(tabs)) + touched)

    n = 4 << 20
    for w in (128, 4096):
        for k in (1, 4, 8):
            for dtype in (torch.int32, torch.int64):
                tabs = [rand_table(w, dtype) for _ in range(k)]
                idx = torch.randint(0, w, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                wg_case(f"W={w} K={k} {str(dtype)[6:]} N={n}", tabs, idx,
                        representative=(w == 4096 and k == 8
                                        and dtype == torch.int64))
    # one call with mixed element sizes; table and index views that are not
    # 16-byte aligned; ragged lengths; tables past the shared-memory budget
    w = 4096
    pool32 = rand_table(w + 8, torch.int32)
    pool64 = rand_table(w + 8, torch.int64)
    poolb = torch.rand(w + 8, generator=gen, device=dev) < 0.5
    mixed = [pool32[:w], pool64[:w], poolb[:w]]
    views = [pool32[1:w + 1], pool64[1:w + 1], poolb[3:w + 3], pool32[2:w + 2]]
    idx = torch.randint(0, w, (n + 4,), generator=gen, device=dev,
                        dtype=torch.int32)
    wg_case(f"W={w} mixed int32+int64+bool N={n}", mixed, idx[:n])
    wg_case(f"W={w} unaligned views N={n + 3}", views, idx[1:])
    for m in (1, 1023, 1025):
        wg_case(f"W={w} mixed N={m}", mixed, idx[:m])
    big_w = kernels.WINDOW_GATHER_TABLE_MAX
    tabs = [rand_table(big_w, torch.int64) for _ in range(3)]
    tabs.append(torch.rand(big_w, generator=gen, device=dev) < 0.5)
    wg_case(f"W={big_w} 3 int64 + bool (past the budget) N={n}", tabs,
            torch.randint(0, big_w, (n,), generator=gen, device=dev,
                          dtype=torch.int32))
    tabs = [rand_table(w, torch.int64) for _ in range(20)]
    wg_case(f"W={w} K=20 int64 (more than one launch holds) N={1 << 20}",
            tabs, idx[:1 << 20])

    n = 8 << 20
    src_len = 4 << 20
    tabs = [rand_table(src_len, torch.int32), rand_table(src_len, torch.int64),
            rand_table(src_len // 2, torch.int32),
            torch.rand(src_len, generator=gen, device=dev) < 0.5]
    mono = torch.sort(torch.randint(0, src_len // 2, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    miss = mono.clone()
    pick = torch.randint(0, n, (n // 100,), generator=gen, device=dev)
    miss[pick] = torch.randint(0, src_len // 2, (n // 100,), generator=gen,
                               device=dev, dtype=torch.int32)
    for label, idx in (("monotone fan-out", mono), ("1% random misses", miss)):
        bwg_case(f"{label} N={n} tables<={src_len}", tabs, idx,
                 representative=(idx is mono))
        bwg_case(f"{label} N={n} tables<={src_len}", tabs, idx, with_ok=False)
    # ragged lengths, unaligned views, indices past the shorter table's end
    # (the zero pad), a sparse stream (windows of 2048 entries all used),
    # and more tables than one launch holds
    half = 4 << 20
    for m in (1, 1023, 1025, half + 3):
        bwg_case(f"monotone N={m}", tabs, mono[:half + 3][:m].contiguous())
    views = [tabs[0][1:], tabs[1][1:], tabs[2][3:], tabs[3][5:]]
    bwg_case(f"unaligned views N={half + 3}", views, mono[1:half + 4])
    bwg_case(f"unaligned views N={half + 3}", views, mono[1:half + 4],
             with_ok=False)
    bwg_case("monotone N=1025", tabs, mono[:1025].contiguous(), with_ok=False)
    wide = torch.sort(torch.randint(0, src_len, (half,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    bwg_case(f"sparse stream past the short table N={half}", tabs, wide)
    many = [rand_table(src_len // 4, torch.int64) for _ in range(20)]
    bwg_case(f"K=20 int64 N={1 << 20}", many,
             (mono[:1 << 20] // 2).contiguous())

    # the device page decode's calls (PAGED_CASES, _decode_inputs). Beside
    # each case's event bracket, the host time to issue a call and the
    # device time torch.profiler records for the kernel and for gather; at
    # 1,900 INT32 pages also with the L2 flushed before every call (body,
    # indices and output, 44.7 MB, fit the 50 MB L2)
    flush = l2_flusher(dev)
    for npages, rows in PAGED_CASES:
        body, idx = _decode_inputs(torch, npages, rows, seed, dev)
        i64 = idx.long()
        rep = (npages, rows) == (1900, 1920)
        label = _paged_label(npages, rows)
        case("paged_window_gather", label,
             lambda: kernels.paged_window_gather(body, idx),
             lambda: kernels.paged_window_gather_plain(body, idx),
             representative=rep, fn_library=lambda: body.gather(1, i64),
             nbytes=4 * (body.numel() + 2 * idx.numel()))
        if kernels.paged_window_gather.last_route != "vector":
            _fail(f"paged_window_gather [{label}]: the decode's call took "
                  f"the {kernels.paged_window_gather.last_route} route")
        paged_device_times(label,
                           lambda: kernels.paged_window_gather(body, idx),
                           lambda: body.gather(1, i64),
                           flush if rep else None)
        del body, idx, i64
    del flush
    # the scalar route (body and index views one word past 16 bytes), then
    # indices outside [0, w) (clamped) with Ro = 1924 on the vector route
    body, idx = _decode_inputs(torch, 1900, 1920, seed + 1, dev)
    pool = torch.empty(body.numel() + idx.numel() + 2, dtype=torch.int32,
                       device=dev)
    bview = pool[1:body.numel() + 1].view(body.shape)
    iview = pool[body.numel() + 2:].view(idx.shape)
    bview.copy_(body)
    iview.copy_(idx)
    wide = torch.randint(-5, 2048 + 5, (1900, 1924), generator=gen,
                         device=dev, dtype=torch.int32)
    for label, b, i, route in (
            ("1900 pages INT32, views one word off", bview, iview, "scalar"),
            ("1900 pages Ro=1924, indices in [-5, w + 5)", body, wide,
             "vector")):
        case("paged_window_gather", label,
             lambda b=b, i=i: kernels.paged_window_gather(b, i),
             lambda b=b, i=i: kernels.paged_window_gather_plain(b, i),
             nbytes=4 * (b.numel() + 2 * i.numel()))
        if kernels.paged_window_gather.last_route != route:
            _fail(f"paged_window_gather [{label}]: route "
                  f"{kernels.paged_window_gather.last_route}, not {route}")
        paged_device_times(label,
                           lambda b=b, i=i: kernels.paged_window_gather(b, i))
    del body, idx, pool, bview, iview, wide
    time_decode(torch, dev, seed)

    # the gather-experiment kernels at the tools' default shapes
    n = 1 << 24

    def tool_inputs(w, shape=None, hi=2 ** 31):
        table = torch.randint(-hi, hi, (w,), generator=gen, device=dev,
                              dtype=torch.int32)
        idx = torch.randint(0, w, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        return (table if shape is None else table.view(shape)), idx

    def table_at(table, idx):
        """The library call of the bodies that are ``table[idx]``."""
        flat, i64 = table.reshape(-1), idx.long()
        return lambda: flat.index_select(0, i64)

    for body, w, shape in (("take", 1 << 20, None),
                           ("take_unique", 1 << 20, None),
                           ("take", 1 << 14, None),
                           ("ta_lanes", 1024, (8, 128))):
        t, i = tool_inputs(w, shape)
        case("pallas_gather", f"{body} w={w} n={n}",
             lambda t=t, i=i, b=body: kernels.pallas_gather(t, i, body=b),
             lambda t=t, i=i, b=body: kernels.pallas_gather_plain(t, i, b),
             representative=(body == "take" and w == 1 << 20),
             fn_library=table_at(t, i) if shape is None else None,
             nbytes=4 * (2 * n + w))
    # the L2 route with sequential positions: the index and output streams
    # alone, every sector of the table used whole
    t, i = tool_inputs(1 << 20)
    seq = (torch.arange(n, device=dev, dtype=torch.int32) & ((1 << 20) - 1))

    def take(i):
        return case("pallas_gather", f"take w={1 << 20} n={n} "
                    f"{'sequential' if i is seq else 'random'} positions",
                    lambda: kernels.pallas_gather(t, i),
                    lambda: kernels.pallas_gather_plain(t, i),
                    fn_library=table_at(t, i), nbytes=4 * (2 * n + (1 << 20)))

    random_ms, seq_ms = take(i), take(seq)
    _log(f"kernel pallas_gather [L2 route]: random positions {random_ms:.4f} "
         f"ms, sequential {seq_ms:.4f} ms: the random sectors cost "
         f"{random_ms - seq_ms:.4f} ms")
    del seq
    # an index view that is not 8-byte aligned, a table view that is not
    # 16-byte aligned on the shared-memory route (staged by the plain
    # loop), indices outside the table, and a single tile (n = blk)
    pool = rand_table((1 << 14) + 8, torch.int32)
    ipool = torch.randint(-5, (1 << 14) + 5, (n + 8,), generator=gen,
                          device=dev, dtype=torch.int32)
    for label, tv, iv in (
            ("unaligned idx view", pool[:1 << 14], ipool[1:n + 1]),
            ("unaligned table view", pool[1:(1 << 14) + 1], ipool[:n]),
            ("both views unaligned", pool[3:(1 << 14) + 3], ipool[3:n + 3]),
            ("one tile", pool[:1 << 14], ipool[5:2048 + 5])):
        m, w = iv.shape[0], tv.shape[0]
        case("pallas_gather", f"take w={w} n={m} {label}",
             lambda tv=tv, iv=iv: kernels.pallas_gather(tv, iv),
             lambda tv=tv, iv=iv: kernels.pallas_gather_plain(tv, iv),
             nbytes=4 * (2 * m + w))
        t2 = tv.view(-1, 128)
        for body in ("rows", "lanes", "sub"):
            case("mk_gather", f"{body} w={w} n={m} {label}",
                 lambda t2=t2, iv=iv, b=body: kernels.mk_gather(t2, iv,
                                                                body=b),
                 lambda t2=t2, iv=iv, b=body: kernels.mk_gather_plain(
                     t2, iv, b),
                 nbytes=4 * (2 * m + w))
    del ipool
    # the L2 route (the 2^20-entry table above) with an unaligned index view
    # and indices outside the table
    ipool = torch.randint(-5, (1 << 20) + 5, (n + 1,), generator=gen,
                          device=dev, dtype=torch.int32)
    case("gather_pallas_vmem", f"w={1 << 20} n={n} blk=4096 unaligned idx "
         f"view, indices in [-5, w + 5)",
         lambda: kernels.gather_pallas_vmem(t, ipool[1:]),
         lambda: kernels.gather_pallas_vmem_plain(t, ipool[1:]),
         nbytes=4 * (2 * n + (1 << 20)))
    del pool, ipool

    # values below 2^24 in magnitude, where the function is ``table[idx]``
    t, i = tool_inputs(2048, hi=2 ** 24)
    case("onehot_gather", f"w=2048 n={n}",
         lambda: kernels.onehot_gather(t, i),
         lambda: kernels.onehot_gather_plain(t, i), representative=True,
         fn_library=table_at(t, i), nbytes=4 * (2 * n + 2048))
    # table values over the whole domain [-2^31, 2^31 - 64), rounded
    # through float32; indices below 0 and at or above w (they read 0); a
    # table length that is no multiple of 4; a table view at an odd offset;
    # a ragged n and an unaligned index view. Held to the plain version (the
    # float64 one-hot product) and to the rounded table read directly.
    m = (1 << 20) + 5
    top = 2 ** 31 - 64
    pool = torch.randint(-top, top, (2048 + 8,), generator=gen, device=dev,
                         dtype=torch.int32)
    pool[:4] = torch.tensor([top - 1, -(2 ** 31), 2 ** 24 + 1, top - 65],
                            dtype=torch.int32, device=dev)
    for label, tv in (("w=2048", pool[:2048]), ("w=2047", pool[:2047]),
                      ("w=2048 at an odd offset", pool[1:2049]),
                      ("w=2047 at an odd offset", pool[3:2050])):
        w = tv.shape[0]
        ipool = torch.randint(-3, w + 3, (m + 1,), generator=gen, device=dev,
                              dtype=torch.int32)
        ipool[:2] = torch.tensor([-(2 ** 31), 2 ** 31 - 1], device=dev)
        rounded = tv.to(torch.float32).to(torch.int64).to(torch.int32)
        if torch.equal(rounded, tv):
            _fail("onehot_gather: the domain case rounds nothing")
        for idx_label, iv in (("", ipool[:m]),
                              (" unaligned idx view", ipool[1:])):
            inside = (iv >= 0) & (iv < w)
            direct = torch.where(inside, rounded[iv.clamp(0, w - 1).long()],
                                 torch.zeros_like(iv))
            if not torch.equal(kernels.onehot_gather(tv, iv), direct):
                _fail(f"onehot_gather [{label}] disagrees with the rounded "
                      f"table read directly")
            case("onehot_gather", f"{label} n={m} whole domain, indices in "
                 f"[-3, w + 3){idx_label}",
                 lambda tv=tv, iv=iv: kernels.onehot_gather(tv, iv),
                 lambda tv=tv, iv=iv: kernels.onehot_gather_plain(tv, iv),
                 nbytes=4 * (2 * m + w))
    del pool, ipool
    for w in (1 << 20, 1 << 14):
        t, i = tool_inputs(w)
        case("gather_pallas_vmem", f"w={w} n={n} blk=4096",
             lambda t=t, i=i: kernels.gather_pallas_vmem(t, i),
             lambda t=t, i=i: kernels.gather_pallas_vmem_plain(t, i),
             representative=(w == 1 << 20), fn_library=table_at(t, i),
             nbytes=4 * (2 * n + w))
    for body, w in (("rows", 1 << 20), ("lanes", 1024), ("2level", 1 << 20),
                    ("2level", 1 << 16), ("2level", 1 << 14), ("sub", 1024)):
        t, i = tool_inputs(w, shape=(-1, 128))
        case("mk_gather", f"{body} w={w} n={n}",
             lambda t=t, i=i, b=body: kernels.mk_gather(t, i, body=b),
             lambda t=t, i=i, b=body: kernels.mk_gather_plain(t, i, b),
             representative=(body == "2level" and w == 1 << 20),
             fn_library=table_at(t, i) if body == "2level" else None,
             nbytes=4 * (2 * n + w))
    return records


def compare_paged(torch, kernels, other_path: str, dev, seed: int) -> None:
    """``--kernels``: this checkout's paged_window_gather beside another
    checkout's (``other_path``, its ``ops/kernels.py``) and gather, at the
    decode's calls, in turns other, this, this, other."""
    import importlib.util

    from radixjoin_tpu_torch.harness.kernel_timing import (bracket_ms,
                                                           device_ms,
                                                           enqueue_ms,
                                                           l2_flusher)

    spec = importlib.util.spec_from_file_location("other_kernels", other_path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.build()
    _log(f"other kernels: {other.__file__}, built in "
         f"{other.BUILD_INFO['seconds']:.1f} s")
    flush = l2_flusher(dev)
    for npages, rows in PAGED_CASES:
        body, idx = _decode_inputs(torch, npages, rows, seed, dev)
        i64 = idx.long()
        want = kernels.paged_window_gather_plain(body, idx)
        bound = 4 * (body.numel() + 2 * idx.numel()) / HBM_BYTES_PER_S * 1e3
        fns = {"other": lambda: other.paged_window_gather(body, idx),
               "this": lambda: kernels.paged_window_gather(body, idx),
               "gather": lambda: body.gather(1, i64)}
        for who in ("other", "this", "this", "other", "gather"):
            fn = fns[who]
            if not torch.equal(fn(), want):
                _fail(f"paged_window_gather [{_paged_label(npages, rows)}]: "
                      f"{who} differs from the plain version")
            dev_ms = device_ms(fn)
            flushed = device_ms(fn, between=flush)
            _log(f"paged [{_paged_label(npages, rows)}] {who}: bracket "
                 f"{bracket_ms(fn):.4f} ms, host to issue a call "
                 f"{enqueue_ms(fn):.4f} ms, device "
                 + (f"{dev_ms:.4f} ms" if dev_ms else "not measured")
                 + ", device with L2 flushed "
                 + (f"{flushed:.4f} ms" if flushed else "not measured")
                 + f"; bound {bound:.4f} ms")
        del body, idx, i64, want


def time_decode(torch, dev, seed: int) -> None:
    """The whole device page decode (``decode_fixed_device``: the upload of
    the host's pages, bitmap unpack, rank, ``paged_window_gather``, the
    masking and for INT64 the reassembly) of an INT32 and an INT64 column
    of random page bytes at 1,900 and 18,878 full pages: wall ms and the
    device ms of each part, so that the kernel's share shows. Held equal to
    the same call on the CPU at 1,900 pages."""
    import numpy as np

    from radixjoin_tpu_torch.dtypes import DataType
    from radixjoin_tpu_torch.harness.kernel_timing import device_times
    from radixjoin_tpu_torch.storage import device_decode as dd

    rng = np.random.default_rng(seed)
    for dtype in (DataType.INT32, DataType.INT64):
        for npages in (1900, 18878):
            pages = rng.integers(0, 256, (npages, 8192), dtype=np.uint8)
            n = npages * dd.ALIGNED_ROWS[dtype]

            def decode():
                return dd.decode_fixed_device(pages, n, dtype, dev)

            if npages == 1900:
                got = decode()
                want = dd.decode_fixed_device(pages, n, dtype, "cpu")
                if not all(torch.equal(g.cpu(), w)
                           for g, w in zip(got, want)):
                    _fail(f"decode_fixed_device {dtype.name} {npages} "
                          f"pages differs from the cpu decode")
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                decode()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = sorted(walls)[2]
            times = device_times(decode, calls=3)
            if not times:
                _log(f"decode {dtype.name} {npages} pages: wall {wall:.3f} "
                     f"ms; device time not measured")
                continue
            total = sum(times.values())
            kernel = sum(v for k, v in times.items()
                         if "paged_gather_kernel" in k)
            copy = sum(v for k, v in times.items() if "memcpy" in k.lower())
            _log(f"decode {dtype.name} {npages} pages ({n} rows, "
                 f"{pages.nbytes / 1e6:.1f} MB of pages): wall {wall:.3f} ms "
                 f"(median of 5); device {total:.4f} ms, of it the upload "
                 f"{copy:.4f} ms, the other torch kernels "
                 f"{total - copy - kernel:.4f} ms and paged_window_gather "
                 f"{kernel:.4f} ms ({100.0 * kernel / total:.1f}% of the "
                 f"device time, {100.0 * kernel / wall:.2f}% of the wall)")
            del pages


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def _result_columns(np, table):
    """Decoded result columns as (valid, value) arrays, NULL values zeroed;
    VARCHAR as bytes objects (b"" where NULL)."""
    host = table.to_host()
    cols = []
    for c in host.columns:
        vals = c.objects() if c.dtype.is_varchar else np.where(c.valid, c.values, 0)
        cols.append((c.valid, vals))
    return host.num_rows, cols


def _same_rows(np, a, b) -> bool:
    """Row multisets equal: every column coded to integers (VARCHAR via a
    joint np.unique), rows sorted with np.lexsort, compared column-wise."""
    na, ca = _result_columns(np, a)
    nb, cb = _result_columns(np, b)
    if na != nb or len(ca) != len(cb):
        return False
    if all(np.array_equal(va, vb) and np.array_equal(xa, xb)
           for (va, xa), (vb, xb) in zip(ca, cb)):
        return True  # equal row for row: no sort needed
    keys_a, keys_b = [], []
    for (va, xa), (vb, xb) in zip(ca, cb):
        if xa.dtype == object:
            _, inv = np.unique(np.concatenate([xa, xb]), return_inverse=True)
            xa, xb = inv[:na], inv[na:]
        keys_a += [va, xa]
        keys_b += [vb, xb]
    oa = np.lexsort(keys_a[::-1])
    ob = np.lexsort(keys_b[::-1])
    return all(np.array_equal(x[oa], y[ob]) for x, y in zip(keys_a, keys_b))


def _expected_root_rows(np, tables, name):
    """Root cardinality from numpy counts over the base tables: every FK in
    these unfiltered plans matches, so the root is the per-key product of
    the two sides' row counts."""
    if name == "S3":
        ci, rt = tables["cast_info"], tables["role_type"]
        role, ids = ci.columns[6], ci.columns[0]
        ok = (role.valid & ids.valid
              & np.isin(role.values, rt.columns[0].values[rt.columns[0].valid]))
        per_id = np.bincount(ids.values[ok]).astype(np.int64)
        return int((per_id * per_id).sum())
    if name == "F1":
        keys = []
        for t in (tables["f64_left"], tables["f64_right"]):
            k = t.columns[0]
            keys.append(k.values[k.valid] + 0.0)  # -0.0 joins 0.0
        u, ca = np.unique(keys[0], return_counts=True)
        ub, cb = np.unique(keys[1], return_counts=True)
        _common, ia, ib = np.intersect1d(u, ub, return_indices=True)
        return int((ca[ia].astype(np.int64) * cb[ib]).sum())

    def per_movie(table, col):
        t = tables[table]
        return np.bincount(t.columns[col].values[t.columns[col].valid],
                           minlength=tables["title"].num_rows + 2)
    if name == "S1":
        a, b = per_movie("movie_info_idx", 1), per_movie("movie_companies", 1)
    else:
        a, b = per_movie("cast_info", 2), per_movie("movie_keyword", 1)
    n = min(len(a), len(b))
    return int((a[:n].astype(np.int64) * b[:n]).sum())


def run_main_path(torch, np, rt, kernels, args):
    from radixjoin_tpu_torch.harness import job_shapes
    from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

    t0 = time.perf_counter()
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES
                       + job_shapes.S3_TABLES) | {"title"})
    tables = SyntheticIMDB(scale=args.scale, seed=args.seed).generate(names)
    _log(f"datagen scale={args.scale} seed={args.seed}: "
         f"{time.perf_counter() - t0:.2f} s, rows "
         + ", ".join(f"{n}={tables[n].num_rows}" for n in names))
    tables.update(job_shapes.f64_tables(seed=args.seed))

    shapes = (("S1", job_shapes.s1_plan, False),
              ("S2", job_shapes.s2_plan, True),
              ("S3", job_shapes.s3_plan, True),
              ("F1", job_shapes.f64_plan, True))
    plans = {}
    for name, build, lazy in shapes:
        t1 = time.perf_counter()
        plans[name] = build(tables, lazy=lazy)
        _log(f"{name}: plan built ({'lazy' if lazy else 'eager pages'}) in "
             f"{time.perf_counter() - t1:.2f} s")

    ctx = rt.build_context()
    torch.cuda.reset_peak_memory_stats()
    results, wall_ms = {}, {}
    kernels.reset_launch_counts()
    for name, _build, _lazy in shapes:
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = rt.execute(plans[name], ctx)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            results[(name, run)] = (res, dict(plans[name]._last_join_totals))
            wall_ms[(name, run)] = ms
            _log(f"{name} {run}: {ms:.1f} ms wall (execute incl. page "
                 f"encode of the result), {res.num_rows} rows")
    launches = kernels.launch_counts()
    _log(f"main path peak device memory: "
         f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
         f"(torch.cuda.max_memory_allocated)")
    _log(f"main path kernel launches: {json.dumps(launches)}")

    strategies = set()
    root_rows = {}
    cpu = rt.build_context("cpu")
    for name, build, lazy in shapes:
        plan_strategies = set(
            plans[name]._fused_struct_cache[1].strategies().values())
        if name in ("S3", "F1") and "merge" not in plan_strategies:
            _fail(f"{name} did not take the merge join: {plan_strategies}")
        strategies |= plan_strategies
        t1 = time.perf_counter()
        oracle_plan = build(tables, lazy=lazy)
        oracle = rt.execute(oracle_plan, cpu)
        _log(f"{name} cpu oracle: {(time.perf_counter() - t1) * 1e3:.1f} ms")
        expected = _expected_root_rows(np, tables, name)
        for run in ("cold", "warm"):
            res, totals = results[(name, run)]
            if totals != oracle_plan._last_join_totals:
                _fail(f"{name} {run}: per-join totals {totals} != cpu "
                      f"{oracle_plan._last_join_totals}")
            if not _same_rows(np, res, oracle):
                _fail(f"{name} {run}: rows differ from the cpu oracle")
        if oracle.num_rows != expected:
            _fail(f"{name}: {oracle.num_rows} rows, numpy count {expected}")
        root_rows[name] = expected
        _log(f"{name}: cold and warm equal the cpu oracle in rows and "
             f"per-join totals {oracle_plan._last_join_totals}; root rows "
             f"{expected} match the numpy count")

    _log(f"strategies: {sorted(strategies)}")
    need = ({"unique_scatter"}, {"csr", "csr_swapped"},
            {"dev_csr", "dev_csr_swapped"}, {"merge"})
    if not all(strategies & s for s in need):
        _fail(f"strategies {sorted(strategies)} miss one of {need}")
    if not all(launches[k] > 0 for k in MAIN_PATH_KERNELS):
        _fail(f"a kernel of the path was not launched: {launches}")
    for name, _build, _lazy in shapes:
        profile_warm(torch, rt, plans[name], ctx, name)
    return {
        "launches": launches, "ctx": ctx, "plans": plans, "tables": tables,
        "shapes": shapes,
        "names": [name for name, _build, _lazy in shapes],
        "warm": {name: results[(name, "warm")][0] for name in plans},
        "totals": {name: results[(name, "warm")][1] for name in plans},
        "warm_ms": {name: wall_ms[(name, "warm")] for name in plans},
        "root_rows": root_rows,
    }


#: kernels the engine's main path launches (S1-S3, F1)
MAIN_PATH_KERNELS = ("window_gather", "blocked_window_gather_multi",
                     "paged_window_gather")
#: kernels the device-time path launches (devtime cases, the three tools)
DEVTIME_PATH_KERNELS = ("window_gather", "blocked_window_gather_multi",
                        "pallas_gather", "gather_pallas_vmem", "mk_gather",
                        "onehot_gather")


# ---------------------------------------------------------------------------
# phase 4: the device-time microbenchmark path
# ---------------------------------------------------------------------------


def run_devtime_path(torch, kernels, args):
    """Every devtime case at ``args.devtime_size`` rows, then the kernel
    cases of the three gather-experiment tools at their default shapes,
    counted. Returns the launch counts of this path."""
    from radixjoin_tpu_torch import hardware
    from radixjoin_tpu_torch.harness import devtime
    from radixjoin_tpu_torch.tools import (expt_gather2, expt_pallas,
                                           expt_primitives)

    dev = torch.device("cuda")
    spec = hardware.detect(dev)
    _log(f"devtime: {spec.name}, HBM {spec.hbm_gbps:.0f} GB/s (published), "
         f"{spec.sm_count} SMs, L2 {spec.l2_bytes / 2**20:.0f} MiB, "
         f"shared memory per block {spec.smem_per_block_bytes} B; "
         f"n = {args.devtime_size:,}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _log(f"{'kernel':<26} {'rows':>12} {'dev_ms':>9} {'rows/s':>9} "
         f"{'GB/s':>8} {'%roof':>7} {'timing':>6}")
    for m in devtime.run(args.devtime_size, device=dev, spec=spec):
        _log(m.row())
    _log(f"devtime: all {len(devtime.CASES)} cases in "
         f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    failed = (
        expt_pallas.main(["--cases", ",".join(expt_pallas.KERNEL_CASES)])
        + expt_primitives.main(["--cases",
                                ",".join(expt_primitives.KERNEL_CASES)])
        + expt_gather2.main())
    if failed:
        _fail(f"tool cases failed: {failed}")
    _log(f"tools: kernel cases in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    _log(f"device-time path kernel launches: {json.dumps(launches)}")
    if not all(launches[k] > 0 for k in DEVTIME_PATH_KERNELS):
        _fail(f"a kernel of the device-time path was not launched: "
              f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: memory and batch
# ---------------------------------------------------------------------------


def _timed_execute(torch, rt, plan, ctx):
    """``(result, wall ms)`` of one ``execute``, the card idle before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.execute(plan, ctx)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


class _Env:
    """Set environment variables for a ``with`` block."""

    def __init__(self, **values):
        self._values = values
        self._old = {}

    def __enter__(self):
        for k, v in self._values.items():
            self._old[k] = os.environ.get(k)
            os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self._old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_memory_and_batch(torch, np, rt, kernels, main):
    """Phase 5 (see the module docstring). Returns its launch counts."""
    from radixjoin_tpu_torch import engine
    from radixjoin_tpu_torch.ops import join as join_ops
    from radixjoin_tpu_torch.plan import fused as fz

    ctx, plans, warm = main["ctx"], main["plans"], main["warm"]
    ledger = engine.device_ledger(ctx.device)
    mib = float(1 << 20)

    def timed_execute(plan):
        return _timed_execute(torch, rt, plan, ctx)

    def check_rows(tag, name, res):
        if not _same_rows(np, res, warm[name]):
            _fail(f"{tag}: {name} differs from the fused result of phase 3")

    def check_no_tally(tag):
        stats = engine.engine_stats()
        if any(stats[k] for k in engine.ENGINE_STATS):
            _fail(f"{tag}: a degradation tally rose: {stats}")

    # nothing is in flight: drop what phases 3 and 4 cached, take the baseline
    engine.clear_device_caches()
    engine.reset_engine_stats()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    _log(f"phase 5: device memory at the start {baseline / mib:.1f} MiB "
         f"allocated, ledger pinned {ledger.pinned_bytes()} bytes")
    kernels.reset_launch_counts()

    # 5a: the stepwise executor
    before = kernels.launch_counts()
    with _Env(RJT_EXEC_MODE="stepwise"):
        for name in ("S1", "F1"):
            res, ms = timed_execute(plans[name])
            check_rows("5a stepwise", name, res)
            _log(f"5a stepwise {name}: {ms:.1f} ms wall, {res.num_rows} rows, "
                 f"equal to the fused result")
    after = kernels.launch_counts()
    for k in ("blocked_window_gather_multi", "paged_window_gather"):
        if after[k] <= before[k]:
            _fail(f"5a stepwise: {k} was not launched: {after}")
    check_no_tally("5a stepwise")
    _log(f"5a stepwise kernel launches: {json.dumps(after)}")

    # 5b: admission spill of S2 through the host-staged radix executor
    s2 = plans["S2"]
    scan_bytes = engine._estimate_scan_bytes(s2)
    budget = scan_bytes // 4
    pairs = []
    count_and_index = join_ops.join_count_and_index

    def counting(*args):
        pairs.append(1)
        return count_and_index(*args)

    before = kernels.launch_counts()
    join_ops.join_count_and_index = counting
    try:
        with _Env(RJT_HBM_BUDGET_BYTES=budget):
            res, ms = timed_execute(s2)
    finally:
        join_ops.join_count_and_index = count_and_index
    after = kernels.launch_counts()
    check_rows("5b spill", "S2", res)
    if res.num_rows != main["root_rows"]["S2"]:
        _fail(f"5b spill: {res.num_rows} rows, numpy count "
              f"{main['root_rows']['S2']}")
    stats = engine.engine_stats()
    if stats["admission_host_spills"] != 1 or stats["oom_retries"]:
        _fail(f"5b spill: tallies {stats}")
    partitions = s2._last_spill_partitions
    rose = (after["blocked_window_gather_multi"]
            - before["blocked_window_gather_multi"])
    if len(pairs) <= len(partitions) or rose < len(pairs):
        _fail(f"5b spill: {len(pairs)} partition pairs over "
              f"{len(partitions)} joins, blocked-window launches rose by "
              f"{rose}")
    _log(f"5b spill S2: budget {budget} bytes (scan bytes {scan_bytes}), "
         f"{ms:.1f} ms wall, {res.num_rows} rows equal to the fused result "
         f"and the numpy count; partitions per join {partitions}, "
         f"{len(pairs)} non-empty partition pairs joined on the card, "
         f"blocked-window launches +{rose}, admission_host_spills 1")
    engine.reset_engine_stats()

    # 5c: eviction under a budget that holds S1 or S3 alone
    _res, _ms = timed_execute(plans["S1"])  # S1's uploads, alone
    s1_pinned = ledger.pinned_bytes()
    budget = max(engine._estimate_query_bytes(plans[n])
                 for n in ("S1", "S3")) + s1_pinned // 2
    evictions = ledger.stats["evictions"]
    with _Env(RJT_HBM_BUDGET_BYTES=budget):
        for name in ("S1", "S3", "S1"):
            res, ms = timed_execute(plans[name])
            check_rows("5c eviction", name, res)
            pinned = ledger.pinned_bytes()
            if pinned > budget:
                _fail(f"5c eviction: pinned {pinned} bytes over the budget "
                      f"{budget}")
            _log(f"5c eviction {name}: {ms:.1f} ms wall, pinned {pinned} "
                 f"bytes of a budget of {budget}, evictions "
                 f"{ledger.stats['evictions'] - evictions}")
    evicted = ledger.stats["evictions"] - evictions
    if evicted <= 0:
        _fail("5c eviction: no eviction fired")
    check_no_tally("5c eviction")
    del res, _res
    engine.clear_device_caches()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated()
    _log(f"5c eviction: {evicted} evictions, S1's uploads {s1_pinned} bytes; "
         f"after clear_device_caches() {left / mib:.3f} MiB allocated "
         f"against {baseline / mib:.3f} MiB at the start of the phase")
    if abs(left - baseline) > (1 << 20) or ledger.pinned_bytes():
        _fail(f"5c eviction: {left} bytes allocated after "
              f"clear_device_caches(), {baseline} before the phase, ledger "
              f"pinned {ledger.pinned_bytes()}")

    # 5d: the batch API, default budget, then a budget that defers plans
    names = main["names"] + main["names"]
    batch = [plans[n] for n in names]
    serial_ms = 2 * sum(main["warm_ms"][n] for n in main["names"])
    refused = []
    reserve = ledger.reserve

    def counting_reserve(est, budget, block=True):
        got = reserve(est, budget, block)
        if got is None:
            refused.append(est)
        return got

    ests = sorted(engine._estimate_query_bytes(p) for p in plans.values())
    tight = ests[-1] + ests[-1] // 4
    for label, env in (("default budget", {}),
                       ("tight budget", {"RJT_HBM_BUDGET_BYTES": tight})):
        for run in ("cold", "warm"):
            del refused[:]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ledger.reserve = counting_reserve
            try:
                with _Env(**env):
                    t0 = time.perf_counter()
                    results = rt.execute_many(batch, ctx)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
            finally:
                del ledger.reserve
            for name, res in zip(names, results):
                check_rows(f"5d batch ({label}, {run})", name, res)
            check_no_tally(f"5d batch ({label}, {run})")
            _log(f"5d batch, {label}"
                 + (f" of {tight} bytes" if env else "")
                 + f", {run}: {len(batch)} plans in {ms:.1f} ms against "
                 f"{serial_ms:.1f} ms for the serial warm runs of phase 3; "
                 f"{len(refused)} admissions deferred, peak device memory "
                 f"{torch.cuda.max_memory_allocated() / mib:.1f} MiB, ledger "
                 f"pinned {ledger.pinned_bytes()} bytes, evictions so far "
                 f"{ledger.stats['evictions']}")
            del results
        if env and not refused:
            _fail("5d batch: the tight budget deferred no plan")

    # 5e: the out-of-memory ladder, with the fault injected from here
    run_fused = fz.run
    calls = []

    def failing(structure):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("injected by chip_smoke.py")
        return run_fused(structure)

    fz.run = failing
    try:
        res, ms = timed_execute(plans["S1"])
    finally:
        fz.run = run_fused
    check_rows("5e out-of-memory ladder", "S1", res)
    stats = engine.engine_stats()
    if (stats["oom_retries"] != 1 or stats["oom_host_spills"]
            or stats["admission_host_spills"] or len(calls) < 2):
        _fail(f"5e out-of-memory ladder: tallies {stats}, {len(calls)} runs")
    _log(f"5e out-of-memory ladder S1: first fused run raised, retried after "
         f"clear_device_caches() in {ms:.1f} ms, oom_retries 1, result equal")
    engine.reset_engine_stats()

    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    _log(f"memory and batch path kernel launches: {json.dumps(launches)}; "
         f"ledger stats {json.dumps(ledger.stats)}")
    if not all(launches[k] > 0 for k in MAIN_PATH_KERNELS):
        _fail(f"a kernel of the memory and batch path was not launched: "
              f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the wave executor, the strategy knobs, SQL to result
# ---------------------------------------------------------------------------


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def run_shared_and_sql(torch, np, rt, kernels, main, args):
    """Phase 6 (see the module docstring). Returns its launch counts and
    the query documents' data and sqlite results for phase 7d."""
    import tempfile
    import warnings

    from radixjoin_tpu_torch import engine
    from radixjoin_tpu_torch.harness import datagen, job_shapes, oracle
    from radixjoin_tpu_torch.harness import run as harness_run
    from radixjoin_tpu_torch.plan import executor as wave
    from radixjoin_tpu_torch.plan import fused as fz
    from radixjoin_tpu_torch.sql import ParsedSQL

    ctx, tables, warm = main["ctx"], main["tables"], main["warm"]
    mib = float(1 << 20)

    def timed_execute(plan):
        return _timed_execute(torch, rt, plan, ctx)

    engine.clear_device_caches()
    engine.reset_engine_stats()
    kernels.reset_launch_counts()

    # 6a: the wave executor at full width
    fetched = []
    fetch = engine._fetch

    def counting_fetch(tensors):
        fetched.append(len(tensors))
        return fetch(tensors)

    for name, build, lazy in main["shapes"]:
        plan = build(tables, lazy=lazy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        paths, syncs = wave.path_stats(), wave.sync_stats()
        line = []
        with _Env(RJT_EXEC_MODE="shared"):
            for run in ("cold", "warm"):
                seen = []
                del fetched[:]
                engine._fetch = counting_fetch
                torch.cuda.set_sync_debug_mode("warn" if run == "warm"
                                               else "default")
                try:
                    with warnings.catch_warnings(record=True) as seen:
                        warnings.simplefilter("always")
                        res, ms = timed_execute(plan)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    engine._fetch = fetch
                if plan._last_join_totals != main["totals"][name]:
                    _fail(f"6a shared {name} {run}: per-join totals "
                          f"{plan._last_join_totals} != fused "
                          f"{main['totals'][name]}")
                if not _same_rows(np, res, warm[name]):
                    _fail(f"6a shared {name} {run}: rows differ from the "
                          f"fused result of phase 3")
                if getattr(plan, "_fused_struct_cache", None) is not None:
                    _fail(f"6a shared {name}: a fused structure was built")
                stats = plan._last_exec_stats
                line.append(
                    f"{run} {ms:.1f} ms ({stats['shrink_syncs']} shrink "
                    f"syncs, {stats['rounds']} fetch rounds, dispatch "
                    f"{stats['dispatch_ms']:.1f} ms)")
                if run == "warm":
                    n_sync = sum("synchroniz" in str(w.message) for w in seen)
                    line.append(f"host syncs seen by torch's sync debug mode "
                                f"{n_sync} for {sum(fetched)} fetched "
                                f"tensors")
                    if stats["shrink_syncs"]:
                        _fail(f"6a shared {name}: a warm run on the feedback "
                              f"made {stats['shrink_syncs']} shrink syncs")
                    if n_sync > sum(fetched) + 1:  # + torch.cuda.synchronize
                        _fail(f"6a shared {name}: {n_sync} host syncs for "
                              f"{sum(fetched)} fetched tensors")
                elif stats["shrink_syncs"] > 1:
                    _fail(f"6a shared {name}: {stats['shrink_syncs']} shrink "
                          f"syncs in one run")
        _log(f"6a shared {name}: " + ", ".join(line)
             + f"; fused warm {main['warm_ms'][name]:.1f} ms; paths "
             f"{json.dumps(_delta(wave.path_stats(), paths))}, syncs "
             f"{json.dumps(_delta(wave.sync_stats(), syncs))}, peak device "
             f"memory {torch.cuda.max_memory_allocated() / mib:.1f} MiB, "
             f"{res.num_rows} rows and per-join totals equal to the fused "
             f"result")
        del plan, res
    launches_6a = kernels.launch_counts()
    _log(f"6a shared kernel launches: {json.dumps(launches_6a)}")
    if not all(launches_6a[k] > 0 for k in MAIN_PATH_KERNELS):
        _fail(f"6a shared: a kernel of the path was not launched: "
              f"{launches_6a}")

    # 6c set-up: the query documents and their query-aware data
    docs = job_shapes.QUERY_DOCUMENTS
    sqls = [docs[name][0] for name in docs]
    used = sorted({e.table for sql in sqls
                   for e in ParsedSQL(sql).alias_map.values()})
    tmp = tempfile.TemporaryDirectory(prefix="rjt_query_documents_")
    plans_path = job_shapes.write_query_documents(tmp.name)
    t0 = time.perf_counter()
    imdb = datagen.SyntheticIMDB(scale=args.scale, seed=args.seed,
                                 queries=sqls).generate()
    t1 = time.perf_counter()
    sqlite = oracle.SqliteOracle({n: imdb[n] for n in used})
    _log(f"6c: {len(docs)} query documents written, query-aware datagen at "
         f"scale {args.scale} in {t1 - t0:.1f} s, sqlite over {len(used)} "
         f"tables ({sum(imdb[n].num_rows for n in used)} rows) loaded in "
         f"{time.perf_counter() - t1:.1f} s")
    source = harness_run.TableSource(host_tables=imdb)
    on_card = harness_run.JobHarness(plans_path, source)
    on_cpu = harness_run.JobHarness(plans_path, source, device="cpu")
    if on_card.context.device.type != "cuda":
        _fail("6c: the harness did not take the card by default")

    # 6b: the declined plan goes to the wave executor in auto mode
    name = job_shapes.VARCHAR_KEY_QUERY
    shared_calls = []
    run_shared = wave.execute_shared
    lowering = fz.FusedPlan._varchar_dev_csr

    def counting_shared(*a):
        shared_calls.append(1)
        return run_shared(*a)

    fz.FusedPlan._varchar_dev_csr = lambda self, *a: None
    wave.execute_shared = counting_shared
    paths = wave.path_stats()
    try:
        parsed, plan = on_card.build_plan(name)
        declined, ms = timed_execute(plan)
    finally:
        fz.FusedPlan._varchar_dev_csr = lowering
        wave.execute_shared = run_shared
    correct, detail = harness_run.verify_result(parsed, plan, declined,
                                                sqlite)
    if shared_calls != [1] or not correct or declined.num_rows == 0:
        _fail(f"6b declined plan: execute_shared calls {shared_calls}, "
              f"{declined.num_rows} rows, verify {correct} ({detail})")
    _log(f"6b declined plan {name}: the fused structure declined the "
         f"VARCHAR key, auto mode served it by execute_shared in {ms:.1f} "
         f"ms, paths {json.dumps(_delta(wave.path_stats(), paths))}, "
         f"{declined.num_rows} rows equal to the row oracle and sqlite")

    # 6c: SQL to result, lazy inputs and eager pages
    small_limit = 1_000_000
    expected, sql_rows, doc_rows = {}, {}, {}
    for eager in ("off", "on"):
        before = kernels.launch_counts()
        with _Env(RJT_EAGER_PAGES=eager):
            for name in docs:
                parsed, plan = on_card.build_plan(name)
                res, ms = timed_execute(plan)
                again, warm_ms = timed_execute(plan)
                actual = res.to_host().to_rows()
                if res.num_rows == 0:
                    _fail(f"6c {name}: empty result, nothing checked")
                if name not in sql_rows:
                    sql_rows[name] = sqlite.query(parsed.executed_sql())
                    n_in = sum(t.num_rows for t in plan.inputs)
                    if n_in < small_limit:
                        t1 = time.perf_counter()
                        expected[name] = oracle.execute_plan_rows(plan)
                        _log(f"6c {name}: row oracle over {n_in} input rows "
                             f"in {time.perf_counter() - t1:.1f} s")
                checks = ["sqlite"]
                ok, detail = oracle.rows_equal(actual, sql_rows[name])
                if ok and name in expected:
                    checks.append("row oracle")
                    ok, detail = oracle.rows_equal(actual, expected[name])
                if not ok:
                    _fail(f"6c {name} (eager pages {eager}): {detail}")
                _parsed, cpu_plan = on_cpu.build_plan(name)
                cpu_res = rt.execute(cpu_plan, on_cpu.context)
                if not (_same_rows(np, res, cpu_res)
                        and _same_rows(np, again, cpu_res)):
                    _fail(f"6c {name} (eager pages {eager}): rows differ "
                          f"from the cpu route")
                if eager == "off":
                    doc_rows[name] = res.num_rows
                _log(f"6c {name} (eager pages {eager}): cold {ms:.1f} ms, "
                     f"warm {warm_ms:.1f} ms, {res.num_rows} rows equal to "
                     f"{', '.join(checks)} and the cpu route; inputs "
                     f"{[t.num_rows for t in plan.inputs]}, strategies "
                     f"{sorted(plan._fused_struct_cache[1].strategies().values())}")
        rose = _delta(kernels.launch_counts(), before)
        _log(f"6c (eager pages {eager}) kernel launches: {json.dumps(rose)}")
        if eager == "on" and not rose.get("paged_window_gather"):
            _fail("6c: eager pages did not reach the paged decode kernel")

    # all five documents through verify_result (row oracle and sqlite) at a
    # tenth of the scale, where the row-by-row oracle finishes every query
    small_scale = args.scale / 10
    small = datagen.SyntheticIMDB(scale=small_scale, seed=args.seed,
                                  queries=sqls).generate()
    small_sqlite = oracle.SqliteOracle({n: small[n] for n in used})
    small_harness = harness_run.JobHarness(
        plans_path, harness_run.TableSource(host_tables=small))
    for mode in ("auto", "shared"):
        t1 = time.perf_counter()
        with _Env(RJT_EXEC_MODE=mode):
            for name in docs:
                res, _ms, correct, detail = small_harness.run_query(
                    name, verify=True, sqlite_oracle=small_sqlite)
                if not correct or res.num_rows == 0:
                    _fail(f"6c {name} at scale {small_scale} ({mode}): "
                          f"{res.num_rows} rows, {detail}")
        _log(f"6c at scale {small_scale}, mode {mode}: all {len(docs)} "
             f"documents verified by verify_result (row oracle and sqlite) "
             f"in {time.perf_counter() - t1:.1f} s")

    # the shrink's copy: a compacted node shrunk mid-plan frees its bucket
    name = "q6a"
    for copy in (True, False):
        _parsed, plan = on_card.build_plan(name)
        syncs = wave.sync_stats()
        wave.SHRINK_COPY = copy
        try:
            # a second sync, so that the wave of the cast_info join (a
            # bucket of cast_info's pad for a few thousand rows) is synced
            with _Env(RJT_EXEC_MODE="shared", RJT_SHRINK_MAX_SYNCS=2):
                rt.execute(plan, ctx)  # uploads cached; buckets still unknown
                del plan._learned_buckets
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                res, ms = timed_execute(plan)
        finally:
            wave.SHRINK_COPY = True
        ok, detail = oracle.rows_equal(res.to_host().to_rows(),
                                       sql_rows[name])
        if not ok:
            _fail(f"6c {name} on the wave executor: {detail}")
        _log(f"6c {name} on the wave executor, shrink "
             f"{'copies' if copy else 'keeps views'}: {ms:.1f} ms, peak "
             f"device memory {torch.cuda.max_memory_allocated() / mib:.1f} "
             f"MiB over {base / mib:.1f} MiB held before the run, syncs of "
             f"the two runs {json.dumps(_delta(wave.sync_stats(), syncs))}, "
             f"rows equal to sqlite")
    on_card.close()
    on_cpu.close()
    small_harness.close()
    del small, small_sqlite
    # phase 7d runs two of the documents again over the same data
    sql_state = {"tmp": tmp, "plans_path": plans_path, "source": source,
                 "sql_rows": sql_rows, "expected": expected,
                 "doc_rows": doc_rows}

    # 6d: each knob against its default, inside whole plans
    knobs = [("default", {}),
             ("RJT_CSR_JOIN=off", {"RJT_CSR_JOIN": "off"}),
             ("RJT_DEV_CSR=off", {"RJT_DEV_CSR": "off"}),
             ("RJT_UNIQUE_JOIN=sort", {"RJT_UNIQUE_JOIN": "sort"}),
             ("RJT_BIG_MERGE=2^21", {"RJT_BIG_MERGE": 1 << 21}),
             ("RJT_BIG_MERGE=2^30", {"RJT_BIG_MERGE": 1 << 30}),
             ("RJT_CARD_FEEDBACK=off", {"RJT_CARD_FEEDBACK": "off"})]
    routes = {}
    for name in ("S2", "S3"):
        build, lazy = {n: (b, z) for n, b, z in main["shapes"]}[name]
        for label, env in knobs:
            plan = build(tables, lazy=lazy)
            with _Env(**env):
                res, cold_ms = timed_execute(plan)
                again, warm_ms = timed_execute(plan)
            if not (_same_rows(np, res, warm[name])
                    and _same_rows(np, again, warm[name])):
                _fail(f"6d {name} under {label}: rows differ from phase 3")
            took = plan._fused_struct_cache[1].strategies()
            routes[(name, label)] = sorted(took.values())
            _log(f"6d {name} under {label}: strategies "
                 f"{json.dumps(took)}, cold {cold_ms:.1f} ms, warm "
                 f"{warm_ms:.1f} ms, feedback "
                 f"{'kept' if hasattr(plan, '_learned_buckets') else 'none'}"
                 f", rows equal")
            del plan, res, again
    moved = {
        ("S2", "RJT_CSR_JOIN=off"), ("S2", "RJT_UNIQUE_JOIN=sort"),
        ("S2", "RJT_BIG_MERGE=2^21"), ("S3", "RJT_UNIQUE_JOIN=sort"),
        ("S3", "RJT_BIG_MERGE=2^30"),
    }
    for key in moved:
        if routes[key] == routes[(key[0], "default")]:
            _fail(f"6d {key[0]}: {key[1]} did not change the route "
                  f"{routes[key]}")
    check = engine.engine_stats()
    if any(check[k] for k in engine.ENGINE_STATS):
        _fail(f"phase 6: a degradation tally rose: {check}")

    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    _log(f"wave executor and SQL path kernel launches: "
         f"{json.dumps(launches)}")
    if not all(launches[k] > 0 for k in MAIN_PATH_KERNELS):
        _fail(f"a kernel of the wave executor and SQL path was not "
              f"launched: {launches}")
    return launches, sql_state


# ---------------------------------------------------------------------------
# phase 7: the distributed layer
# ---------------------------------------------------------------------------


class _HostResult:
    """A HostTable where ``_same_rows`` reads ``to_host()``."""

    def __init__(self, host):
        self.host = host
        self.num_rows = host.num_rows

    def to_host(self):
        return self.host


def _dist_run(torch, dx, plan, mesh, config):
    """One ``execute_distributed``: ``(result, wall ms, host syncs seen by
    torch's sync debug mode, collective-stats delta)``."""
    import warnings

    from radixjoin_tpu_torch.parallel import multihost

    torch.cuda.synchronize()
    before = multihost.collective_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            host = dx.execute_distributed(plan, mesh=mesh, config=config)
            ms = (time.perf_counter() - t0) * 1e3  # ends in a host fetch
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = multihost.collective_stats()
    n_sync = sum("synchroniz" in str(w.message) for w in seen)
    return host, ms, n_sync, {k: after[k] - before[k] for k in after}


def _profile_device(torch, label: str, fn) -> None:
    """Run ``fn()`` once under torch.profiler and log its wall ms, the
    device's busy ms (device-side kernel and copy time summed), the idle
    share and the eight largest device events."""
    from radixjoin_tpu_torch.harness import kernel_timing

    prof = kernel_timing.profile_busy(fn)
    if prof["busy_ms"] is None:
        _log(f"{label} profile: device time not measured (the profiler "
             f"reported none)")
        return
    _log(f"{label} profile: {prof['wall_ms']:.1f} ms wall under the "
         f"profiler, device busy {prof['busy_ms']:.3f} ms, idle share "
         f"{prof['idle_share']:.3f}")
    for e in prof["events"][:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
             f"{e.key[:90]}")


def _same_columns(np, a, b, ordered: bool = True) -> bool:
    """Equal ``table_columns`` lists (floats by bit pattern): row for row,
    or as row multisets when not ``ordered``."""
    if len(a) != len(b):
        return False
    keys_a, keys_b = [], []
    for (va, xa), (vb, xb) in zip(a, b):
        if len(xa) != len(xb):
            return False
        if xa.dtype == np.float64:
            xa, xb = xa.view(np.int64), xb.view(np.int64)
        if xa.dtype == object:
            _, inv = np.unique(np.concatenate([xa, xb]), return_inverse=True)
            xa, xb = inv[:len(xa)], inv[len(xa):]
        keys_a += [va, xa]
        keys_b += [vb, xb]
    if not ordered and keys_a:
        oa, ob = np.lexsort(keys_a[::-1]), np.lexsort(keys_b[::-1])
        keys_a = [k[oa] for k in keys_a]
        keys_b = [k[ob] for k in keys_b]
    return all(np.array_equal(x, y) for x, y in zip(keys_a, keys_b))


def run_distributed(torch, np, rt, kernels, main, sql, args):
    """Phase 7 (see the module docstring). Returns its launch counts."""
    import pickle
    import tempfile

    import torch.distributed as dist

    from radixjoin_tpu_torch.dtypes import DataType
    from radixjoin_tpu_torch.harness import oracle
    from radixjoin_tpu_torch.harness import run as harness_run
    from radixjoin_tpu_torch.parallel import (DistJoinConfig, make_mesh,
                                              multihost)
    from radixjoin_tpu_torch.parallel import dist_executor as dx
    from radixjoin_tpu_torch.parallel import dist_join
    from radixjoin_tpu_torch.plan.ir import Plan
    from radixjoin_tpu_torch.storage.columnar import ColumnarTable, HostTable
    from radixjoin_tpu_torch.tools import multihost_worker as worker

    tables, warm = main["tables"], main["warm"]
    mib = float(1 << 20)
    kernels.reset_launch_counts()

    # 7a: a one-rank NCCL group; the plans of phase 3 cold, then warm
    multihost.init(f"localhost:{multihost.free_port()}", 1, 0)
    mesh = make_mesh()
    if mesh.backend != "nccl" or mesh.device.type != "cuda":
        _fail(f"7a: the mesh is {mesh.backend} on {mesh.device}")
    _log(f"7a: one-rank {mesh.backend} group, rank {mesh.rank} of "
         f"{mesh.size}, on {mesh.device}")
    builds = {n: (b, z) for n, b, z in main["shapes"]}
    for name, build, lazy in main["shapes"]:
        before = kernels.launch_counts()
        line = []
        for run in ("cold", "warm"):
            plan = build(tables, lazy=lazy)  # warm: a fresh plan object
            host, ms, syncs, coll = _dist_run(torch, dx, plan, mesh, None)
            stats = plan._last_dist_stats
            if not _same_rows(np, _HostResult(host), warm[name]):
                _fail(f"7a {name} {run}: rows differ from phase 3's fused "
                      f"result")
            if run == "warm" and (stats["replayed"] != stats["joins"]
                                  or stats["rerun"] or syncs > 2):
                _fail(f"7a {name} warm: {stats}, {syncs} host syncs (the "
                      f"root's check and gather expected)")
            line.append(
                f"{run} {ms:.1f} ms ({stats['replayed']} of "
                f"{stats['joins']} joins replayed, {syncs} host syncs seen "
                f"by the sync debug mode, {coll['host_syncs']} fetches, "
                f"{coll['calls']} collective calls moving "
                f"{coll['bytes'] / mib:.1f} MiB)")
        rose = _delta(kernels.launch_counts(), before)
        _profile_device(torch, f"7a {name} warm",
                        lambda: dx.execute_distributed(
                            build(tables, lazy=lazy), mesh=mesh))
        _log(f"7a {name}: " + ", ".join(line) + f"; fused warm "
             f"{main['warm_ms'][name]:.1f} ms (phase 3); {host.num_rows} "
             f"rows equal to phase 3's; kernel launches {json.dumps(rose)}")
    build, lazy = builds["S2"]
    for label, config in (("exchange_chunks=3",
                           DistJoinConfig(exchange_chunks=3)),
                          ("bloom_max_bits=0",
                           DistJoinConfig(bloom_max_bits=0))):
        line = []
        for run in ("cold", "warm"):
            plan = build(tables, lazy=lazy)
            host, ms, syncs, coll = _dist_run(torch, dx, plan, mesh, config)
            if not _same_rows(np, _HostResult(host), warm["S2"]):
                _fail(f"7a S2 {label} {run}: rows differ from phase 3")
            line.append(f"{run} {ms:.1f} ms ({syncs} host syncs, "
                        f"{coll['calls']} collective calls, "
                        f"{coll['bytes'] / mib:.1f} MiB)")
        _log(f"7a S2 with {label}: " + ", ".join(line) + ", rows equal")
    # the worker's scenarios at one rank: what 7c's two ranks must give
    ns = (DataType, Plan, ColumnarTable, HostTable)
    one_rank = {}
    for scenario in worker.SCENARIOS:
        for chunks in (0, 3):
            plan = worker.build_scenario(scenario, *ns)
            expected = oracle.execute_plan_rows(plan)
            config = DistJoinConfig(exchange_chunks=max(1, chunks))
            for run in ("cold", "warm"):
                host = dx.execute_distributed(plan, mesh=mesh, config=config)
                ok, detail = oracle.rows_equal(host.to_rows(), expected)
                if not ok:
                    _fail(f"7a scenario {scenario} chunks={chunks} {run}: "
                          f"{detail}")
            one_rank[f"{scenario}/{chunks}"] = worker.table_columns(host)
    _log(f"7a: the scenarios {list(one_rank)} cold and warm equal the row "
         f"oracle")

    # 7b: the join layer at size
    rng = np.random.default_rng(args.seed)
    nb, npr = DIST_JOIN_ROWS
    bk = rng.permutation(nb).astype(np.int64)  # every key once, 0 .. nb-1
    bx = rng.integers(0, 1 << 30, nb).astype(np.int32)
    pk = rng.integers(0, 2 * nb, npr).astype(np.int64)
    hot = rng.random(npr) < 0.6
    pk[hot] = int(bk[0])
    bv, pv = np.ones(nb, bool), np.ones(npr, bool)
    py = np.arange(npr, dtype=np.int64)
    matched = pk < nb
    want_rows = np.flatnonzero(matched)
    row_of_key = np.empty(nb, np.int64)
    row_of_key[bk] = np.arange(nb)
    in_bytes = nb * (8 + 1 + 4) + npr * (8 + 1 + 8)
    out_bytes = len(want_rows) * (8 + 4 + 8 + 1)
    _log(f"7b: {nb} build rows (int64 key, int32 payload), {npr} probe rows "
         f"(int64 key, int64 row id), key {int(bk[0])} on "
         f"{hot.mean() * 100:.1f}% of the probe side; {len(want_rows)} "
         f"matches by numpy; inputs {in_bytes / 1e9:.3f} GB, output "
         f"{out_bytes / 1e9:.3f} GB")
    for label, config in (("monolithic", DistJoinConfig()),
                          ("exchange_chunks=3",
                           DistJoinConfig(exchange_chunks=3))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _run in range(2):
            info = {}
            t0 = time.perf_counter()
            columns, live, totals = dist_join.distributed_join(
                bk, bv, {"x": bx}, pk, pv, {"y": py}, mesh=mesh,
                config=config, info_out=info)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        shards = dist_join.shard_inputs(mesh, bk, bv, {"x": bx}, pk, pv,
                                        {"y": py})
        dev_times = []
        for _run in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist_join.distributed_join_device(
                *shards, mesh, info["hot_keys"],
                np.ones(len(info["hot_keys"]), bool), config)
            torch.cuda.synchronize()
            dev_times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        _profile_device(torch, f"7b {label} distributed_join_device",
                        lambda: dist_join.distributed_join_device(
                            *shards, mesh, info["hot_keys"],
                            np.ones(len(info["hot_keys"]), bool), config))
        del shards
        out = dist_join.collect_to_host(columns, live, mesh)
        del columns, live
        got_y = out["p.y"]
        if int(np.sum(totals)) != len(want_rows) or len(got_y) != len(
                want_rows):
            _fail(f"7b {label}: {len(got_y)} rows, totals {totals}, numpy "
                  f"{len(want_rows)}")
        if not np.array_equal(np.sort(got_y), want_rows):
            _fail(f"7b {label}: the matched probe rows differ from numpy's")
        pick = rng.integers(0, len(got_y), 1 << 16)
        y = got_y[pick]
        if not (np.array_equal(out["__build_key"][pick], pk[y])
                and np.array_equal(out["b.x"][pick],
                                   bx[row_of_key[pk[y]]])):
            _fail(f"7b {label}: sampled output rows differ from numpy")
        _log(f"7b {label}: info {json.dumps({k: (v.tolist() if hasattr(v, 'tolist') else v) for k, v in info.items()})}; "
             f"distributed_join {times[0]:.1f} / {times[1]:.1f} ms "
             f"(upload, hot-key detection and join), "
             f"distributed_join_device {dev_times[0]:.1f} / "
             f"{dev_times[1]:.1f} ms; peak device memory "
             f"{peak / mib:.1f} MiB (torch.cuda.max_memory_allocated); "
             f"{len(got_y)} rows: every matched probe row once, 65536 "
             f"sampled rows equal to numpy")
        del out, got_y
    dist.destroy_process_group()

    # 7c: two ranks on this one card over gloo, one process each
    repo = os.path.dirname(os.path.abspath(__file__))
    outdir = tempfile.mkdtemp(prefix="rjt_dist_ranks_")
    port = multihost.free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.multihost_worker",
         "--pid", str(r), "--nprocs", "2", "--port", str(port),
         "--device", DIST_RANK_DEVICE, "--backend", "gloo",
         "--out", os.path.join(outdir, f"rank{r}.pkl"),
         "--dist-chunks", "0,3"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            _fail(f"7c: rank {r} exited {p.returncode}:\n{log[-3000:]}")
    records = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            records.append(pickle.load(f))  # written by the ranks above
    for rec in records:
        if rec["backend"] != "gloo" or rec["device"] != DIST_RANK_DEVICE:
            _fail(f"7c: rank {rec['rank']} ran {rec['backend']} on "
                  f"{rec['device']}")
        for key, want in one_rank.items():
            for run in ("cold", "warm"):
                got = rec["plans"][key][run]["columns"]
                if not _same_columns(np, got, want, ordered=False):
                    _fail(f"7c rank {rec['rank']} {key} {run}: rows differ "
                          f"from 7a's one rank")
                if not _same_columns(
                        np, got, records[0]["plans"][key][run]["columns"]):
                    _fail(f"7c {key} {run}: the ranks' results differ")
    times = {k: (round(v["cold"]["ms"], 1), round(v["warm"]["ms"], 1),
                 v["warm"]["host_syncs"])
             for k, v in records[0]["plans"].items()}
    _log(f"7c: two ranks on {DIST_RANK_DEVICE} over gloo in {time.perf_counter() - t0:.1f}"
         f" s: every scenario cold and warm equal on both ranks (row for row) "
         f"and to 7a's one rank (as row multisets); rank 0 (cold ms, warm ms, warm fetches): "
         f"{json.dumps(times)}")

    # 7d: the SQL entry point with the harness's distributed switch
    on_card = harness_run.JobHarness(sql["plans_path"], sql["source"])
    on_card.distributed = True
    for name in ("q1a", "q_varchar"):
        line = []
        for run in ("cold", "warm"):
            res, ms, _c, _d = on_card.run_query(name)
            actual = res.to_host().to_rows()
            checks = ["sqlite"]
            ok, detail = oracle.rows_equal(actual, sql["sql_rows"][name])
            if ok and name in sql["expected"]:
                checks.append("row oracle")
                ok, detail = oracle.rows_equal(actual, sql["expected"][name])
            if not ok or res.num_rows == 0:
                _fail(f"7d {name} {run}: {res.num_rows} rows, {detail}")
            line.append(f"{run} {ms:.1f} ms")
        _log(f"7d {name} through JobHarness.run_query with distributed on "
             f"({on_card.dist_mesh().backend}, one rank): "
             f"{', '.join(line)}, {res.num_rows} rows equal to "
             f"{' and '.join(checks)}")
    on_card.close()
    if dist.is_initialized():
        _fail("7d: the harness left its process group open")
    sql["tmp"].cleanup()

    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    _log(f"distributed path kernel launches: {json.dumps(launches)}")
    if not all(launches[k] > 0 for k in DIST_PATH_KERNELS):
        _fail(f"a kernel of the distributed path was not launched: "
              f"{launches}")
    return launches


#: kernels the distributed path launches (the merge join's expansion)
DIST_PATH_KERNELS = ("window_gather", "blocked_window_gather_multi")
#: 7b's build and probe rows
DIST_JOIN_ROWS = (1 << 22, 1 << 24)
#: the device both ranks of 7c share
DIST_RANK_DEVICE = "cuda:0"


# ---------------------------------------------------------------------------
# phase 8: the bench, the fuzz campaign, the roofline and the scaling bench
# ---------------------------------------------------------------------------


def _subprocess(label: str, cmd, timeout: float, **env):
    """Run ``cmd`` from the repository root with ``env`` over this process's
    environment (a value of None removes the variable); fail the smoke on a
    non-zero exit. Returns ``(stdout, stderr)``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ)
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    proc = subprocess.run(cmd, cwd=repo, env=full, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        _fail(f"{label}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-3000:]}")
    return proc.stdout, proc.stderr


def _bench_join_cluster(label: str, nprocs: int, device, backend, rows: int):
    """The worker's ``bench_join`` on ``nprocs`` rank processes; rank 0's
    record, its result rows held to numpy."""
    import tempfile

    import numpy as np

    from radixjoin_tpu_torch.parallel import multihost
    from radixjoin_tpu_torch.tools import multihost_worker as worker

    repo = os.path.dirname(os.path.abspath(__file__))
    outdir = tempfile.mkdtemp(prefix="rjt_bench_join_")
    port = multihost.free_port()
    extra = (["--device", device] if device else []) + (
        ["--backend", backend] if backend else [])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.multihost_worker",
         "--pid", str(r), "--nprocs", str(nprocs), "--port", str(port),
         "--scenario", "bench_join", "--bench-rows", str(rows),
         "--repeats", "3", "--out", os.path.join(outdir, f"rank{r}.json")]
        + extra, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            _fail(f"{label}: rank {r} exited {p.returncode}:\n{log[-3000:]}")
    with open(os.path.join(outdir, "rank0.json")) as f:
        record = json.load(f)
    bk, bv, _bp, pk, pv, _pp = worker.bench_join_inputs(rows)
    want = int((pv & np.isin(pk, bk[bv])).sum())
    if record["result_rows"] != want or record["processes"] != nprocs:
        _fail(f"{label}: {record['result_rows']} rows on "
              f"{record['processes']} ranks, numpy {want}")
    _log(f"{label}: {record['processes']} rank(s), {record['backend']} on "
         f"{record['device']}, {rows} probe rows: best "
         f"{record['best_ms']:.2f} ms, mean {record['mean_ms']:.2f} ms, "
         f"sigma {record['sigma_ms']:.2f} ms over 3 runs after "
         f"{record['warmup_dropped']} warm-ups; {want} rows equal to numpy")
    return record


def run_tools(torch, np, kernels, sql, args):
    """Phase 8 (see the module docstring). Returns the launch counts of
    8a-8d apart (``bench``, ``fuzz``, ``roofline``, ``scaling``) and
    summed (``tools``)."""
    from radixjoin_tpu_torch import engine, hardware
    from radixjoin_tpu_torch.harness import roofline
    from radixjoin_tpu_torch.tools import fuzz_campaign, scaling_bench

    # 8a: the bench as a user runs it, over the built-in documents
    engine.clear_device_caches()
    t0 = time.perf_counter()
    out, err = _subprocess(
        "8a bench", [sys.executable, "-m", "radixjoin_tpu_torch.bench"], 900,
        BENCH_PLANS="builtin", BENCH_SCALE=str(args.scale),
        **{k: None for k in ("BENCH_PLATFORM", "BENCH_REPEAT",
                             "BENCH_BATCH", "BENCH_DEVICE_MS",
                             "BENCH_SECONDARY_SCALE", "BENCH_QUERIES",
                             "BENCH_SQL_DIR", "BENCH_RSS_PROFILE")})
    bench_s = time.perf_counter() - t0
    lines = out.splitlines()
    if len(lines) != 1:
        _fail(f"8a: the bench printed {len(lines)} lines on stdout")
    rec = json.loads(lines[0])
    d = rec["detail"]
    want_rows = sum(sql["doc_rows"].values())
    if d["backend"] != "cuda" or d["queries"] != len(sql["doc_rows"]):
        _fail(f"8a: backend {d['backend']}, {d['queries']} queries")
    if d["result_rows"] != want_rows:
        _fail(f"8a: {d['result_rows']} result rows, phase 6c verified "
              f"{want_rows} against sqlite ({json.dumps(sql['doc_rows'])})")
    tallies = [d["degradations"], d.get("degradations_process", {}),
               d.get("secondary", {}).get("degradations", {})]
    if any(v for t in tallies for k, v in t.items() if k != "queries"):
        _fail(f"8a: a degradation tally rose: {json.dumps(tallies)}")
    missing = [k for k in ("device_ms", "batch_wall_ms", "secondary",
                           "stage_split_ms", "warmup_phase_s")
               if k not in d]
    if missing or d["device_ms"]["queries_measured"] != d["queries"]:
        _fail(f"8a: bonus stages did not report: {missing}; "
              f"{json.dumps(d.get('device_ms'))}")
    bench_launches = d["launches"]
    if not all(bench_launches[k] > 0 for k in DIST_PATH_KERNELS):
        _fail(f"8a: a kernel of the bench's path was not launched: "
              f"{json.dumps(bench_launches)}")
    for line in err.splitlines():
        if line.startswith("bench: ") and ("best ms" in line
                                           or "join paths" in line
                                           or "warmup" in line):
            _log(f"8a {line}")
    _log(f"8a bench ({bench_s:.1f} s): {rec['metric']} = {rec['value']} ms, "
         f"vs_baseline {rec['vs_baseline']}; per-query best "
         f"{json.dumps(d['slowest'])}; batch {d['batch_wall_ms']} ms; stage "
         f"split {json.dumps(d['stage_split_ms'])}; device ms "
         f"{json.dumps(d['device_ms'])}; secondary "
         f"{json.dumps(d['secondary'])}; {d['result_rows']} rows equal to "
         f"phase 6c's sqlite-checked rows; degradations zero; kernel "
         f"launches {json.dumps(bench_launches)}")

    # 8b: the fuzz campaign in this process, on the card
    kernels.reset_launch_counts()
    stats = fuzz_campaign.run_campaign(FUZZ_SEEDS, 0,
                                       fuzz_campaign.MODES)
    if stats["failures"] or min(stats["runs"].values()) < FUZZ_SEEDS:
        _fail(f"8b fuzz campaign: {stats}")
    fuzz_launches = kernels.launch_counts()
    _log(f"8b fuzz campaign: seeds [0, {FUZZ_SEEDS}) x "
         f"{list(fuzz_campaign.MODES)} clean in {stats['seconds']:.1f} s, "
         f"checked runs {json.dumps(stats['runs'])}, kernel launches "
         f"{json.dumps(fuzz_launches)}")

    # 8c: the roofline harness
    kernels.reset_launch_counts()
    spec = hardware.detect()
    for m in roofline.run(ROOFLINE_SIZE, 5, spec=spec):
        _log(f"8c roofline {m.kernel:<20} rows {m.rows:>9,} {m.ms:9.3f} ms "
             f"({m.mode}) {m.rows_per_s / 1e9:7.3f} G rows/s "
             f"{m.eff_gbps:8.1f} GB/s, {m.pct_roofline * 100:5.1f}% of "
             f"{spec.hbm_gbps:.0f} GB/s")
    torch.cuda.synchronize()
    roofline_launches = kernels.launch_counts()
    _log(f"8c roofline kernel launches (wrapper calls): "
         f"{json.dumps(roofline_launches)}")

    # 8d: weak scaling at one NCCL rank; the worker's bench_join on one
    # NCCL rank and on two gloo ranks sharing this card
    engine.clear_device_caches()
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="rjt_scaling_"), "out.json")
    out, _err = _subprocess(
        "8d scaling_bench", [sys.executable, "-m",
                             "radixjoin_tpu_torch.tools.scaling_bench",
                             "--ndev", "1", "--mode", "join", "--breakdown",
                             "--rows", str(SCALING_ROWS), "--json", path],
        600)
    with open(path) as f:
        (res,) = json.load(f)
    bk, bv, _bpl, pk, pv, _ppl = scaling_bench.make_join_data(
        1, SCALING_ROWS, 0.2)
    want = int((pv & np.isin(pk, bk[bv])).sum())
    if res["out_rows"] != want or res["backend"] != "nccl":
        _fail(f"8d scaling_bench: {res}, numpy {want}")
    _log(f"8d scaling_bench --ndev 1 ({res['backend']} on {res['device']}): "
         f"{res['probe_rows']} probe rows in {res['s'] * 1e3:.2f} ms, "
         f"{res['probe_rows_per_s'] / 1e6:.2f} M rows/s; exchange "
         f"{res['phase_exchange_ms']:.2f} ms, expand "
         f"{res['phase_expand_ms']:.2f} ms, local sort+count "
         f"{res['local_sort_count_ms']:.2f} ms, {res['bytes_sent_per_dev']:,} "
         f"bytes in {res['collective_calls']} collective calls; {want} rows "
         f"equal to numpy")
    one = _bench_join_cluster("8d bench_join one NCCL rank", 1, None, None,
                              BENCH_JOIN_ROWS)
    two = _bench_join_cluster("8d bench_join two gloo ranks",
                              2, DIST_RANK_DEVICE, "gloo", BENCH_JOIN_ROWS)
    if one["result_rows"] != two["result_rows"]:
        _fail("8d bench_join: one rank and two ranks differ")
    scaling_launches = {k: res["launches"][k] + one["launches"][k]
                        + two["launches"][k] for k in fuzz_launches}
    _log(f"8d kernel launches (rank 0 of each cluster): "
         f"{json.dumps(scaling_launches)}")

    launches = {"bench": bench_launches, "fuzz": fuzz_launches,
                "roofline": roofline_launches, "scaling": scaling_launches}
    launches["tools"] = {k: sum(c[k] for c in launches.values())
                         for k in fuzz_launches}
    _log(f"phase 8 kernel launches: {json.dumps(launches['tools'])}")
    if not all(launches["tools"][k] > 0 for k in DIST_PATH_KERNELS):
        _fail(f"a kernel of the tools' path was not launched: {launches}")
    return launches


#: 8b's seeds (every one in each of the six modes)
FUZZ_SEEDS = 256
#: 8c's probe rows
ROOFLINE_SIZE = 1 << 22
#: 8d: probe rows a rank of scaling_bench (its default) and of bench_join
SCALING_ROWS = 200_000
BENCH_JOIN_ROWS = 1 << 20


def profile_warm(torch, rt, plan, ctx, name: str) -> None:
    """Where a warm run's time goes: the fused run with its fetches and
    root decode, the result page encode, and the device's busy time from
    torch.profiler (device-side kernel and copy time summed), hence its
    idle share."""
    from radixjoin_tpu_torch import engine
    from radixjoin_tpu_torch.harness import kernel_timing

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = engine._execute_fused(plan, ctx)
    t1 = time.perf_counter()
    engine._encode_result(host)
    t2 = time.perf_counter()
    prof = kernel_timing.profile_busy(lambda: rt.execute(plan, ctx))
    _log(f"{name} warm breakdown: fused run + fetch + root decode "
         f"{(t1 - t0) * 1e3:.1f} ms, result page encode "
         f"{(t2 - t1) * 1e3:.1f} ms; the engine's own stage clock "
         f"{json.dumps(plan._last_exec_stats)}")
    if prof["busy_ms"] is None:
        _log(f"{name} warm profile: device time not measured (the "
             f"profiler reported none)")
        return
    _log(f"{name} warm profile: execute {prof['wall_ms']:.1f} ms wall under "
         f"the profiler, device busy {prof['busy_ms']:.3f} ms, idle share "
         f"{prof['idle_share']:.3f}")
    for e in prof["events"][:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
             f"{e.key[:90]}")
    # the hand kernels at this plan's own call shapes
    for e in prof["events"]:
        if "bwg_kernel" in e.key or "gather_kernel" in e.key:
            _log(f"{name} warm hand kernel: "
                 f"{e.self_device_time_total / 1e3:.4f} ms over {e.count} "
                 f"launches of {e.key[:60]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devtime-size", type=int, default=1 << 22)
    ap.add_argument("--kernels", default=None,
                    help="another checkout's ops/kernels.py: compare its "
                         "paged_window_gather with this one's, and stop")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a card")
    import numpy as np

    import radixjoin_tpu_torch as rt
    from radixjoin_tpu_torch.ops import kernels

    # phase 1: environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"card: {smi}")
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    kernels.build()
    _log(f"kernel build: {kernels.BUILD_INFO['seconds']:.1f} s -> "
         f"{', '.join(kernels.BUILD_INFO['paths'])}")
    for line in str(kernels.BUILD_INFO["log"]).splitlines():
        if "Used" in line or "Compiling entry" in line:
            _log(f"  ptxas: {line.strip()}")

    clock = [t_start]

    def phase_done(label: str) -> None:
        clock.append(time.perf_counter())
        _log(f"{label}: {clock[-1] - clock[-2]:.1f} s, "
             f"{clock[-1] - t_start:.1f} s since the start")

    phase_done("phase 1 (environment and build)")
    dev = torch.device("cuda")
    if args.kernels:
        compare_paged(torch, kernels, args.kernels, dev, args.seed)
        phase_done("paged_window_gather against the other checkout's")
        return
    # phase 2: kernels against their plain versions
    records = check_kernels(torch, kernels, dev, args.seed)
    phase_done("phase 2 (kernel checks)")
    # phase 3: the main path, counted
    main_path = run_main_path(torch, np, rt, kernels, args)
    launches = main_path["launches"]
    phase_done("phase 3 (main path)")
    # phase 4: the device-time path, counted
    dt_launches = run_devtime_path(torch, kernels, args)
    phase_done("phase 4 (device-time path)")
    # phase 5: memory and batch, counted
    mb_launches = run_memory_and_batch(torch, np, rt, kernels, main_path)
    phase_done("phase 5 (memory and batch)")
    # phase 6: the wave executor, the knobs, SQL to result, counted
    sq_launches, sql_state = run_shared_and_sql(torch, np, rt, kernels,
                                                main_path, args)
    phase_done("phase 6 (wave executor, knobs, SQL to result)")
    # phase 7: the distributed layer, counted
    dist_launches = run_distributed(torch, np, rt, kernels, main_path,
                                    sql_state, args)
    phase_done("phase 7 (distributed layer)")
    # phase 8: the bench, the fuzz campaign, roofline and scaling, counted
    tools_launches = run_tools(torch, np, kernels, sql_state, args)
    phase_done("phase 8 (bench, fuzz campaign, roofline, scaling)")
    _log(f"card: {smi}")

    meta = {
        "window_gather": ("csrc/window_gather.cu",
                          "radixjoin_tpu/ops/pallas_kernels.py:164"),
        "blocked_window_gather_multi": (
            "csrc/blocked_window_gather.cu",
            "radixjoin_tpu/ops/pallas_kernels.py:340"),
        "paged_window_gather": ("csrc/paged_window_gather.cu",
                                "radixjoin_tpu/ops/pallas_kernels.py:231"),
        "pallas_gather": ("csrc/resident_gather.cu",
                          "tools/expt_pallas.py:39"),
        "onehot_gather": ("csrc/resident_gather.cu",
                          "tools/expt_pallas.py:108"),
        "gather_pallas_vmem": ("csrc/resident_gather.cu",
                               "tools/expt_primitives.py:94"),
        "mk_gather": ("csrc/resident_gather.cu", "tools/expt_gather2.py:52"),
    }
    out = []
    for name, (src, replaces) in meta.items():
        rec = records[name]
        counted = launches if name in MAIN_PATH_KERNELS else dt_launches
        out.append({
            "name": name, "route": "cuda",
            "source": f"radixjoin_tpu_torch/{src}", "replaces": replaces,
            "launches": counted[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": rec["library_ms"],
            "pct_of_bound": rec["pct_of_bound"],
            "launches_memory_batch": mb_launches[name],
            "launches_shared_sql": sq_launches[name],
            "launches_dist": dist_launches[name],
            "launches_bench": tools_launches["bench"][name],
            "launches_fuzz": tools_launches["fuzz"][name],
            "launches_roofline": tools_launches["roofline"][name],
            "launches_scaling": tools_launches["scaling"][name],
            "launches_tools": tools_launches["tools"][name],
        })
        _log(f"{name}: the times below are at {rec['shape']}; bound from "
             f"{rec['bound_bytes']} bytes at {HBM_BYTES_PER_S / 1e9:.0f} "
             f"GB/s (published)")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
