"""The port's distributed layer across real processes: gloo clusters of 2, 3
and 4 ranks on the CPU.

One module fixture starts the three clusters at once, each rank a
``radixjoin_tpu_torch.tools.multihost_worker`` process (torch and numpy
only) launched by ``subprocess``, and each cluster runs every scenario in
one launch: the ``two_join``, ``skew`` and ``empty`` plans cold and warm,
monolithic and with a chunked exchange of 3, each checked against the row
oracle on every rank, and the eight join cases of
tests/test_distributed.py. Here, every rank's gathered results must be
identical, and equal to the JAX package on ``make_mesh(N)`` of this
process's 8-device CPU mesh: rows in the same order, the same per-rank
totals, ``info`` and hot keys. A group of 3 is no power of two, so a
routing hash taken modulo 3 as a signed number would send rows to other
ranks than the JAX package's uint64 hash and change the row order.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.parallel import DistJoinConfig as RefConfig
from radixjoin_tpu.parallel import make_mesh as ref_make_mesh
from radixjoin_tpu.parallel.dist_executor import (
    execute_distributed as ref_execute_distributed)
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable
from radixjoin_tpu.storage.columnar import HostTable as RefHostTable

from radixjoin_tpu_torch.tools.multihost_worker import (
    SCENARIOS, build_scenario, join_cases, table_columns)

from test_distributed import reference_join
from test_torch_dist import _free_port, ref_join

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3, 4)
CHUNKS = (0, 3)


class _Clusters:
    """The running clusters; ``[world]`` waits for that cluster's ranks and
    returns their records, so the JAX references are computed while the
    ranks still run."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["OMP_NUM_THREADS"] = "1"
        self.procs, self.done = {}, {}
        for world in WORLDS:
            port = _free_port()
            self.procs[world] = [subprocess.Popen(
                [sys.executable, "-m",
                 "radixjoin_tpu_torch.tools.multihost_worker",
                 "--pid", str(r), "--nprocs", str(world), "--port", str(port),
                 "--device", "cpu", "--out", str(self._out(world, r)),
                 "--dist-chunks", ",".join(map(str, CHUNKS)),
                 "--join-cases"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for r in range(world)]

    def _out(self, world, rank):
        return self.tmp / f"w{world}r{rank}.pkl"

    def __getitem__(self, world):
        if world not in self.done:
            ranks = self.procs[world]
            logs = [p.communicate(timeout=300)[0] for p in ranks]
            for r, (p, log) in enumerate(zip(ranks, logs)):
                assert p.returncode == 0, (
                    f"world {world} rank {r} failed:\n{log[-4000:]}")
            records = []
            for r in range(world):
                with open(self._out(world, r), "rb") as f:
                    records.append(pickle.load(f))  # written by our workers
            self.done[world] = records
        return self.done[world]

    def stop(self):
        for ranks in self.procs.values():
            for p in ranks:
                if p.poll() is None:
                    p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Every cluster starts at once, before the first test."""
    running = _Clusters(tmp_path_factory.mktemp("clusters"))
    try:
        yield running
    finally:
        running.stop()


def _same(a, b) -> bool:
    """Equal nested results: dicts, lists, tuples and numpy arrays
    (floats by bit pattern)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        if a.dtype == np.float64:
            a, b = a.view(np.int64), b.view(np.int64)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


# The JAX references are computed first in each test: the clusters run
# meanwhile. Tests run in file order, so the tests that only read the
# records come last.


@pytest.mark.parametrize("world", WORLDS)
def test_join_cases_match_reference(clusters, world):
    """Every join case against the JAX package's, in the group of 3; in the
    groups of 2 and 4 the chunked cases (the costliest to compile for the
    JAX mesh) against the numpy nested-hash join, the others against JAX."""
    mesh = ref_make_mesh(world)
    want, by_oracle = {}, []
    for name, (bk, bv, bp, pk, pv, pp, configs) in join_cases().items():
        for i, overrides in enumerate(configs):
            if world != 3 and "exchange_chunks" in overrides:
                by_oracle.append((f"{name}/{i}", bp, pp,
                                  reference_join(bk, bv, bp, pk, pv, pp)))
                continue
            want[f"{name}/{i}"] = ref_join(bk, bv, bp, pk, pv, pp, mesh,
                                           RefConfig(**overrides))
    for key, bp, pp, rows in by_oracle:
        out = clusters[world][0]["joins"][key]["out"]
        names = (["__build_key"] + [f"b.{k}" for k in bp]
                 + [f"p.{k}" for k in pp])
        assert sorted(zip(*[out[n].tolist() for n in names])) == rows, key
    for key, (rows, totals, info, hot_keys) in want.items():
        got = clusters[world][0]["joins"][key]
        assert got["out"].keys() == rows.keys()
        for k in rows:
            assert got["out"][k].dtype == rows[k].dtype
            np.testing.assert_array_equal(got["out"][k], rows[k],
                                          err_msg=f"{key} {k}")
        np.testing.assert_array_equal(got["totals"], totals)
        for k in ("cap_b", "cap_p", "hot_cap", "s_pad", "bloom_bits",
                  "chunks", "ngroups"):
            assert got["info"][k] == info[k], (key, k)
        np.testing.assert_array_equal(got["info"]["hot_keys"], hot_keys)


@pytest.mark.parametrize("world", WORLDS)
def test_plans_match_reference(clusters, world):
    """Cold and warm rows of the scenarios with rows, in order, against the
    JAX package's cold run: monolithic in every group, chunked in the group
    of 3. The runs not compared here (chunked in the other groups; the
    ``empty`` scenario, whose root has no row to order) are held to the
    row oracle on every rank and to each other."""
    mesh = ref_make_mesh(world)
    want = {}
    for scenario in [s for s in SCENARIOS if s != "empty"]:
        for chunks in (CHUNKS if world == 3 else (0,)):
            plan = build_scenario(scenario, RefDataType, RefPlan, RefTable,
                                  RefHostTable)
            want[f"{scenario}/{chunks}"] = table_columns(
                ref_execute_distributed(
                    plan, mesh=mesh,
                    config=RefConfig(exchange_chunks=max(1, chunks))))
    for key, columns in want.items():
        got = clusters[world][0]["plans"][key]
        for run in ("cold", "warm"):
            assert _same(got[run]["columns"], columns), (key, run)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gathers_the_same_result(clusters, world):
    records = clusters[world]
    assert [r["rank"] for r in records] == list(range(world))
    assert all(r["size"] == world and r["backend"] == "gloo"
               and r["active"] for r in records)
    first = records[0]
    assert len(first["plans"]) == len(SCENARIOS) * len(CHUNKS)
    assert len(first["joins"]) == sum(len(c[-1])
                                      for c in join_cases().values())
    for rec in records[1:]:
        for part in ("plans", "joins"):
            for key in first[part]:
                got, want = dict(rec[part][key]), dict(first[part][key])
                for run in ("cold", "warm"):
                    if run in got:  # timings and byte counts are per rank
                        got[run] = got[run]["columns"]
                        want[run] = want[run]["columns"]
                assert _same(got, want), (world, part, key)


@pytest.mark.parametrize("world", WORLDS)
def test_warm_replay_makes_no_sync_a_join(clusters, world):
    """Cold: a hot-key sample and a ladder step in each of the three joins
    at least; warm: the root's batched check and its gather, no more."""
    for key, rec in clusters[world][0]["plans"].items():
        assert rec["cold"]["host_syncs"] >= 2 * 3 + 1, key
        assert rec["warm"]["host_syncs"] == 2, key
        assert rec["cold"]["calls"] > 0 and rec["cold"]["bytes"] > 0, key
