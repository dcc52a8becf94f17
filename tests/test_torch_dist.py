"""The port's distributed layer (radixjoin_tpu_torch/parallel/) against the
JAX package's (radixjoin_tpu/parallel/), in one process on the CPU.

* The per-rank functions (``dest_of``, ``_chunk_of``, ``bucketize``,
  ``detect_hot_keys``) and the unsigned hash helpers equal the JAX
  functions bit for bit and dtype for dtype, called outside ``shard_map``.
* A one-rank gloo group in this process (opened by a module fixture,
  destroyed at its teardown) runs the eight join cases of
  tests/test_distributed.py through the port's ``distributed_join``: rows
  in the same order after ``collect_to_host``, the same per-rank totals,
  ``info`` and hot keys as the JAX package on ``make_mesh(1)``, and the
  rows of a numpy nested-hash join.
* ``execute_distributed`` on plans (empty / type mismatch, stale feedback,
  VARCHAR and FP64 keys, tiny JOB shapes): the same rows in the same order
  as the JAX ``execute_distributed`` and, as a multiset, as the port's
  single-card ``execute`` on the CPU; the warm replay makes no host sync a
  join and re-learns after a mismatch.

Tolerance 0 throughout: every compared value is an integer, a bool, a
string or an FP64 bit pattern. Inputs come from numpy generators with
fixed seeds.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import radixjoin_tpu as ref
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.parallel import DistJoinConfig as RefConfig
from radixjoin_tpu.parallel import dist_executor as ref_exec
from radixjoin_tpu.parallel import dist_join as ref_dj
from radixjoin_tpu.parallel import make_mesh as ref_make_mesh
from radixjoin_tpu.parallel import shuffle as ref_shuffle
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable
from radixjoin_tpu.storage.columnar import HostColumn as RefHostColumn
from radixjoin_tpu.storage.columnar import HostTable as RefHostTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.oracle import rows_equal
from radixjoin_tpu_torch.ops.hashing import murmur64, murmur64_np, udiv, umod
from radixjoin_tpu_torch.parallel import (DistJoinConfig, dist_executor,
                                          dist_join, make_mesh, multihost,
                                          shuffle)
from radixjoin_tpu_torch.tools.multihost_worker import (join_cases,
                                                        table_columns)

from test_distributed import reference_join
from test_torch_engine import SEMANTICS, port_rows

DT = ref.DataType


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process, left at teardown."""
    multihost.init(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _hash_keys():
    """Keys around 0 and over the whole int64 range; many of their hashes
    have bit 63 set, where signed and unsigned remainders differ."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([np.arange(-5000, 5000, dtype=np.int64),
                           rng.integers(-2**63, 2**63 - 1, 20000,
                                        dtype=np.int64)])
    assert (murmur64_np(keys) >> np.uint64(63)).any()
    return keys


# ---------------------------------------------------------------------------
# per-rank functions, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 1000, 2**31 - 1])
def test_umod_udiv_match_numpy_uint64(n):
    keys = _hash_keys()
    h = murmur64(torch.from_numpy(keys))
    hu = murmur64_np(keys)
    np.testing.assert_array_equal(umod(h, n).numpy().astype(np.uint64),
                                  hu % np.uint64(n))
    np.testing.assert_array_equal(udiv(h, n).numpy().view(np.uint64),
                                  hu // np.uint64(n))


def test_umod_rejects_divisors_out_of_range():
    h = torch.zeros(3, dtype=torch.int64)
    for n in (0, -1, 2**31):
        with pytest.raises(ValueError):
            umod(h, n)


@pytest.mark.parametrize("ndev", [2, 3, 4, 8])
@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_dest_of_and_chunk_of_match_reference(ndev, chunks):
    keys = _hash_keys()
    t, j = torch.from_numpy(keys), jnp.asarray(keys)
    got = shuffle.dest_of(t, ndev)
    want = np.asarray(ref_shuffle.dest_of(j, ndev))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got = dist_join._chunk_of(t, ndev, chunks)
    want = np.asarray(ref_dj._chunk_of(j, ndev, chunks))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_signed_remainder_would_misroute():
    """Why the helpers exist: torch's signed ``%`` of the hash's int64
    pattern sends thousands of keys to another rank than the JAX
    package's uint64 ``dest_of`` when the group size is no power of two."""
    keys = np.arange(-5000, 5000, dtype=np.int64)
    naive = (murmur64(torch.from_numpy(keys)) % 3).numpy()
    want = np.asarray(ref_shuffle.dest_of(jnp.asarray(keys), 3))
    assert (naive != want).sum() > 1000
    np.testing.assert_array_equal(
        shuffle.dest_of(torch.from_numpy(keys), 3).numpy(), want)


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_bucketize_matches_reference(keep, chunks):
    """Send buffers (keys, valid, int32 / int64 / bool payloads) and the
    overflow count at a capacity that overflows, with and without a keep
    mask, monolithic and chunked."""
    rng = np.random.default_rng(3)
    n, ndev, cap = 3000, 3, 150
    keys = rng.integers(-2000, 2000, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    keep_np = rng.random(n) > 0.3
    pay = {"a": rng.integers(-9, 9, n).astype(np.int32),
           "b": rng.integers(-2**40, 2**40, n).astype(np.int64),
           "c": rng.random(n) > 0.5}
    tk = torch.from_numpy(keys)
    jk = jnp.asarray(keys)
    kw_t = dict(keep=torch.from_numpy(keep_np) if keep else None)
    kw_j = dict(keep=jnp.asarray(keep_np) if keep else None)
    if chunks > 1:
        kw_t.update(chunks=chunks,
                    chunk_ids=dist_join._chunk_of(tk, ndev, chunks))
        kw_j.update(chunks=chunks,
                    chunk_ids=ref_dj._chunk_of(jk, ndev, chunks))
    got = shuffle.bucketize(
        tk, torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in pay.items()}, ndev, cap, **kw_t)
    want = ref_shuffle.bucketize(
        jk, jnp.asarray(valid), {k: jnp.asarray(v) for k, v in pay.items()},
        ndev, cap, **kw_j)
    pairs = [(got[0], want[0]), (got[1], want[1]), (got[3], want[3])] + [
        (got[2][k], want[2][k]) for k in pay]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[3]) > 0  # the capacity overflowed


@pytest.mark.parametrize("n,hot,cfg", [
    (5000, 0.4, {}),
    (200_000, 0.2, {}),                      # sampled (n > sample_size)
    (200_000, 0.05, {"max_hot_keys": 1, "hot_threshold": 0.01}),
])
def test_detect_hot_keys_matches_reference(n, hot, cfg):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1000, n).astype(np.int64)
    keys[rng.random(n) < hot] = 11
    keys[rng.random(n) < hot / 2] = 12
    valid = rng.random(n) > 0.05
    got = dist_join.detect_hot_keys(keys, valid, DistJoinConfig(**cfg), 3,
                                    max(16, n // 4))
    want = ref_dj.detect_hot_keys(keys, valid, RefConfig(**cfg), 3,
                                  max(16, n // 4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 0


def test_global_histogram_equals_numpy(mesh):
    keys = _hash_keys()
    valid = np.random.default_rng(1).random(len(keys)) > 0.2
    got = shuffle.global_histogram(torch.from_numpy(keys),
                                   torch.from_numpy(valid), 7, mesh)
    want = np.bincount((murmur64_np(keys) % np.uint64(7))[valid]
                       .astype(np.int64), minlength=7)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# distributed_join against the JAX package
# ---------------------------------------------------------------------------


def ref_join(bk, bv, bp, pk, pv, pp, mesh, config):
    """The JAX package's ``distributed_join``, step by step so that its
    ``info`` and hot keys can be read: ``(rows, totals, info, hot_keys)``."""
    ndev = mesh.devices.size
    kb, vb, bpl, kp, vp, ppl = ref_dj.shard_inputs(mesh, bk, bv, bp,
                                                   pk, pv, pp)
    chunks = max(1, int(config.exchange_chunks))
    cap_p = max(16, int(config.capacity_factor * (kp.shape[0] // ndev)
                        / (ndev * chunks)) + 1)
    hot_keys, hot_valid = ref_dj.detect_hot_keys(
        ref_dj._pad_to_shards(pk, ndev),
        ref_dj._pad_to_shards(pv.astype(bool), ndev, fill=False),
        config, ndev, cap_p)
    info = {}
    columns, live, totals = ref_dj.distributed_join_device(
        kb, vb, bpl, kp, vp, ppl, mesh, hot_keys, hot_valid, config,
        info_out=info)
    rows = {k: np.asarray(v) for k, v in
            ref_dj.collect_to_host(columns, live).items()}
    return rows, np.asarray(totals), info, hot_keys


def assert_join_equal(got_rows, got_totals, got_info, want):
    rows, totals, info, hot_keys = want
    assert set(got_rows) == set(rows)
    for k in rows:
        assert got_rows[k].dtype == rows[k].dtype, k
        np.testing.assert_array_equal(got_rows[k], rows[k], err_msg=k)
    np.testing.assert_array_equal(got_totals, totals)
    for k in ("cap_b", "cap_p", "hot_cap", "s_pad", "bloom_bits", "chunks",
              "ngroups"):
        assert got_info[k] == info[k], k
    np.testing.assert_array_equal(got_info["hot_keys"], hot_keys)


CASES = [(name, i) for name, case in join_cases().items()
         for i in range(len(case[-1]))]


@pytest.mark.parametrize("name,i", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_join_case_matches_reference(mesh, name, i):
    bk, bv, bp, pk, pv, pp, configs = join_cases()[name]
    info = {}
    columns, live, totals = dist_join.distributed_join(
        bk, bv, bp, pk, pv, pp, mesh=mesh,
        config=DistJoinConfig(**configs[i]), info_out=info)
    rows = dist_join.collect_to_host(columns, live, mesh)
    assert_join_equal(rows, totals, info,
                      ref_join(bk, bv, bp, pk, pv, pp, ref_make_mesh(1),
                               RefConfig(**configs[i])))
    names = ["__build_key"] + [f"b.{k}" for k in bp] + [f"p.{k}" for k in pp]
    got = sorted(zip(*[rows[n].tolist() for n in names]))
    assert got == reference_join(bk, bv, bp, pk, pv, pp)


def test_config_fields_and_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(DistJoinConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    assert ours == theirs


def test_from_reference_carries_a_config_over():
    want = RefConfig(capacity_factor=3.0, max_hot_keys=4, bloom_max_bits=0,
                     exchange_chunks=3, feedback=False)
    got = convert.from_reference(want)
    assert isinstance(got, DistJoinConfig)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ---------------------------------------------------------------------------
# execute_distributed against the JAX package and the single-card engine
# ---------------------------------------------------------------------------


def _empty_and_mismatch():
    """tests/test_distributed.py::test_distributed_plan_empty_and_mismatch."""
    plan = RefPlan()
    t0 = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        [[1, 10], [2, 20]], [DT.INT32, DT.INT64])))
    t1 = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        [[10, 1]], [DT.INT64, DT.INT32])))
    s0 = plan.new_scan_node(t0, [(0, DT.INT32), (1, DT.INT64)])
    s1 = plan.new_scan_node(t1, [(1, DT.INT32)])
    plan.root = plan.new_join_node(
        True, s0, s1, 1, 0, [(0, DT.INT32), (2, DT.INT32)])
    return plan


def _two_key_plan(bkeys, pkeys):
    """The stale-feedback plan of tests/test_distributed.py."""
    plan = RefPlan()
    tb = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        [[int(k), i] for i, k in enumerate(bkeys)], [DT.INT64, DT.INT64])))
    tp = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        [[int(k), i * 10] for i, k in enumerate(pkeys)],
        [DT.INT64, DT.INT64])))
    sb = plan.new_scan_node(tb, [(0, DT.INT64), (1, DT.INT64)])
    sp = plan.new_scan_node(tp, [(0, DT.INT64), (1, DT.INT64)])
    plan.root = plan.new_join_node(
        True, sb, sp, 0, 0, [(1, DT.INT64), (3, DT.INT64)])
    return plan


def _fp64_keys():
    """FP64 keys with -0.0 / 0.0, NaN (never matches), NULLs and duplicates;
    NaN and -0.0 also as payloads."""
    rng = np.random.default_rng(8)
    pool = [0.0, -0.0, float("nan"), 1.5, -2.25, 1e300, None]

    def rows(n, seed_off):
        return [[pool[int(i)], float(rng.random()) if j % 5 else -0.0, j]
                for j, i in enumerate(rng.integers(0, len(pool), n))]

    plan = RefPlan()
    tb = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        rows(300, 0), [DT.FP64, DT.FP64, DT.INT64])))
    tp = plan.new_input(RefTable.from_host(RefHostTable.from_rows(
        rows(500, 1), [DT.FP64, DT.FP64, DT.INT64])))
    sb = plan.new_scan_node(tb, [(0, DT.FP64), (1, DT.FP64), (2, DT.INT64)])
    sp = plan.new_scan_node(tp, [(0, DT.FP64), (2, DT.INT64)])
    plan.root = plan.new_join_node(
        False, sb, sp, 0, 0, [(0, DT.FP64), (1, DT.FP64), (4, DT.INT64)])
    return plan


@pytest.fixture(scope="module")
def imdb():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    tables = RefIMDB(scale=0.0004, seed=0).generate(names)
    for name, t in job_shapes.f64_tables(n=3000, seed=0).items():
        # the port's FP64 tables as the JAX package's host tables
        tables[name] = RefHostTable(t.num_rows, [
            RefHostColumn(DT(int(c.dtype)), c.values.copy(), c.valid.copy())
            for c in t.columns])
    return tables


def _job_plan(imdb, shape):
    build, lazy = {"s1": (job_shapes.s1_plan, False),
                   "s2": (job_shapes.s2_plan, True),
                   "f64": (job_shapes.f64_plan, True)}[shape]
    return build(imdb, lazy=lazy, plan_cls=RefPlan, table_cls=RefTable)


PLANS = {
    "empty_and_mismatch": lambda imdb: _empty_and_mismatch(),
    "varchar_join_keys": lambda imdb: SEMANTICS["varchar_join_keys"](),
    "varchar_join_keys_fuse": lambda imdb: SEMANTICS[
        "varchar_join_keys_fuse"](),
    "fp64_keys_zero_and_nan": lambda imdb: SEMANTICS[
        "fp64_keys_zero_and_nan"](),
    "fp64_keys_nulls_and_payloads": lambda imdb: _fp64_keys(),
    "three_way_join_tree": lambda imdb: SEMANTICS["three_way_join_tree"](),
    "null_payloads_flow_through": lambda imdb: SEMANTICS[
        "null_payloads_flow_through"](),
    "scan_only_plan": lambda imdb: SEMANTICS["scan_only_plan"](),
    "job_s1": lambda imdb: _job_plan(imdb, "s1"),
    "job_s2": lambda imdb: _job_plan(imdb, "s2"),
    "job_f1": lambda imdb: _job_plan(imdb, "f64"),
}


def assert_same_columns(got, want):
    assert got.num_rows == want.num_rows
    for (gv, gx), (wv, wx) in zip(table_columns(got), table_columns(want)):
        np.testing.assert_array_equal(gv, wv)
        if gx.dtype == np.float64:  # FP64 by bit pattern (NaN, -0.0)
            gx, wx = gx.view(np.int64), wx.view(np.int64)
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_reference_and_single_card(mesh, imdb, name):
    ref_plan = PLANS[name](imdb)
    want = ref_exec.execute_distributed(ref_plan, mesh=ref_make_mesh(1))
    got = dist_executor.execute_distributed(
        convert.from_reference(ref_plan), mesh=mesh)
    assert_same_columns(got, want)
    single = port.execute(convert.from_reference(ref_plan),
                          port.build_context("cpu"))
    ok, detail = rows_equal(port_rows(port.ColumnarTable.from_host(got)),
                            port_rows(single))
    assert ok, detail
    if name == "empty_and_mismatch":
        assert got.num_rows == 0
    if name.startswith("job"):
        assert got.num_rows > 0


def test_stale_feedback_reruns_cold_and_relearns(mesh):
    """Same plan shape and row counts, other data: the warm replay's learned
    totals cannot match, the root check fails, and the cold rerun is exact
    and learns anew (tests/test_distributed.py:238-282)."""
    rng = np.random.default_rng(9)
    n = 600
    r1 = _two_key_plan(rng.integers(0, 50, n), rng.integers(0, 50, n))
    r2 = _two_key_plan(rng.integers(100, 105, n), rng.integers(100, 105, n))
    p1, p2 = convert.from_reference(r1), convert.from_reference(r2)
    base = dist_executor._fb_base_key(p1, mesh, DistJoinConfig())
    assert dist_executor._fb_base_key(p2, mesh, DistJoinConfig()) == base
    ref_mesh = ref_make_mesh(1)

    got1 = dist_executor.execute_distributed(p1, mesh=mesh)
    assert_same_columns(got1, ref_exec.execute_distributed(r1, mesh=ref_mesh))
    learned_1 = dist_executor._DIST_FEEDBACK[base + (p1.root,)]["totals"]

    before = multihost.collective_stats()["host_syncs"]
    got2 = dist_executor.execute_distributed(p2, mesh=mesh)
    syncs = multihost.collective_stats()["host_syncs"] - before
    assert_same_columns(got2, ref_exec.execute_distributed(r2, mesh=ref_mesh))
    learned_2 = dist_executor._DIST_FEEDBACK[base + (p2.root,)]["totals"]
    assert not np.array_equal(learned_1, learned_2)
    assert p2._last_dist_stats == {"joins": 1, "replayed": 0, "rerun": True}
    # the failed check, then a cold run: hot-key sample, ladder, gather
    assert syncs >= 1 + 3


def test_warm_replay_makes_no_sync_a_join(mesh):
    """Cold: a hot-key sample and at least one ladder fetch a join. Warm
    (a fresh plan object of the same content): no sync in any join — one
    batched check at the root and the root's gather. Same rows."""
    from radixjoin_tpu_torch.tools.multihost_worker import build_scenario

    def build():
        from radixjoin_tpu_torch.dtypes import DataType
        from radixjoin_tpu_torch.plan.ir import Plan
        from radixjoin_tpu_torch.storage.columnar import (ColumnarTable,
                                                          HostTable)

        return build_scenario("two_join", DataType, Plan, ColumnarTable,
                              HostTable)

    config = DistJoinConfig(capacity_factor=1.75)  # a key of its own
    runs = []
    for plan in (build(), build()):
        before = multihost.collective_stats()
        out = dist_executor.execute_distributed(plan, mesh=mesh,
                                                config=config)
        after = multihost.collective_stats()
        runs.append((out, after["host_syncs"] - before["host_syncs"],
                     plan._last_dist_stats))
    (cold, cold_syncs, cold_stats), (warm, warm_syncs, warm_stats) = runs
    assert cold_stats == {"joins": 3, "replayed": 0, "rerun": False}
    assert warm_stats == {"joins": 3, "replayed": 3, "rerun": False}
    assert cold_syncs >= 2 * 3 + 1
    assert warm_syncs == 2
    assert_same_columns(warm, cold)


def test_put_sharded_and_fetch_round_trip(mesh):
    """A one-rank group: the shard is the whole array, ``fetch`` gives it
    back, and ``active()`` is false (one rank shares the group)."""
    a = np.arange(-7, 9, dtype=np.int64)
    t = multihost.put_sharded(a, mesh)
    assert t.dtype == torch.int64 and t.device == mesh.device
    np.testing.assert_array_equal(multihost.fetch(t, mesh), a)
    b = np.array([True, False, True])
    np.testing.assert_array_equal(
        multihost.fetch(multihost.put_sharded(b, mesh), mesh), b)
    assert not multihost.active()
    a[0] = 100  # the upload is a copy
    assert int(t[0]) == -7


def test_make_mesh_needs_a_group_and_names_the_card(mesh, monkeypatch):
    if torch.cuda.is_available():
        assert make_mesh().device.type == "cuda"  # the default is the card
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="multihost.init"):
        make_mesh(device="cpu")
