"""The port's oracles (harness/oracle.py), query-aware generator and
harness (harness/run.py: ``TableSource``, ``JobHarness``, ``verify_result``,
the CLI) against the JAX package's on the same inputs, and the port's
``execute`` against both oracles on the query documents of
harness/job_shapes.py and on generated plans: equal row multisets,
tolerance 0. The port runs on ``build_context("cpu")``.
"""

import json
import os

import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu.harness import datagen as ref_datagen
from radixjoin_tpu.harness import oracle as ref_oracle
from radixjoin_tpu.harness import run as ref_run

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch.harness import datagen as port_datagen
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness import oracle as port_oracle
from radixjoin_tpu_torch.harness import run as port_run
from radixjoin_tpu_torch.plan import executor as port_exec

from test_fuzz_plans import gen_plan
from test_torch_engine import SEMANTICS, assert_same_tables, port_rows

DOCS = job_shapes.QUERY_DOCUMENTS
SQLS = [DOCS[name][0] for name in DOCS]
SCALE = 0.001


@pytest.fixture(autouse=True)
def default_modes(monkeypatch):
    for name in ("RJT_EXEC_MODE", "RJT_EAGER_PAGES", "RJT_HBM_BUDGET_BYTES"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    """The query documents written to a directory: ``(plans.json, dir)``."""
    directory = str(tmp_path_factory.mktemp("query_documents"))
    return job_shapes.write_query_documents(directory), directory


@pytest.fixture(scope="module")
def port_tables():
    return port_datagen.SyntheticIMDB(scale=SCALE, seed=0,
                                      queries=SQLS).generate()


@pytest.fixture(scope="module")
def harness(documents, port_tables):
    h = port_run.JobHarness(documents[0],
                            port_run.TableSource(host_tables=port_tables),
                            device="cpu")
    yield h
    h.close()


@pytest.fixture(scope="module")
def sqlite(port_tables):
    return port_oracle.SqliteOracle(port_tables)


# ---------------------------------------------------------------------------
# the written documents
# ---------------------------------------------------------------------------


def test_written_documents_have_the_benchmarks_layout(documents):
    path, directory = documents
    with open(path) as f:
        doc = json.load(f)
    assert doc["names"] == list(DOCS) and len(doc["names"]) >= 4
    assert doc["sql_directory"] == "job"
    assert port_datagen.load_job_queries(
        os.path.join(directory, "job"), doc["names"]) == SQLS
    kinds = set()

    def walk(node):
        kinds.add(node["Node Type"])
        for child in node.get("Plans", []):
            walk(child)

    for plan in doc["plans"]:
        walk(plan["Plan"])
    assert kinds == {"Aggregate", "Gather", "Hash Join", "Hash", "Seq Scan"}
    assert job_shapes.VARCHAR_KEY_QUERY in DOCS


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(DOCS))
def test_query_document_against_both_oracles(name, harness, sqlite,
                                             documents, port_tables):
    """``execute`` of the port == the port's row oracle == sqlite on the
    rewritten SQL == the JAX package's row oracle over its own plan of the
    same document; and every document returns rows (an empty result checks
    nothing)."""
    result, _ms, correct, detail = harness.run_query(
        name, verify=True, sqlite_oracle=sqlite)
    assert correct, detail
    assert result.num_rows > 0
    parsed, plan = harness.build_plan(name)
    assert plan._name == name
    rows = port_oracle.execute_plan_rows(plan)
    assert port_oracle.rows_equal(result.to_host().to_rows(), rows)[0]
    ref_harness = ref_run.JobHarness(
        documents[0], ref_run.TableSource(host_tables=_ref_tables()),
        os.path.join(documents[1], "job"))
    _parsed, ref_plan = ref_harness.build_plan(name)
    ok, msg = ref_oracle.rows_equal(
        port_rows(result), ref_oracle.execute_plan_rows(ref_plan))
    assert ok, msg
    ok, msg = ref_oracle.rows_equal(
        port_rows(result),
        _ref_sqlite().query(parsed.executed_sql()))
    assert ok, msg


_REF_CACHE = {}


def _ref_tables():
    if "tables" not in _REF_CACHE:
        _REF_CACHE["tables"] = ref_datagen.SyntheticIMDB(
            scale=SCALE, seed=0, queries=SQLS).generate()
    return _REF_CACHE["tables"]


def _ref_sqlite():
    if "sqlite" not in _REF_CACHE:
        _REF_CACHE["sqlite"] = ref_oracle.SqliteOracle(_ref_tables())
    return _REF_CACHE["sqlite"]


@pytest.mark.parametrize("seed", range(1000, 1008))
def test_row_oracle_on_fuzz_plans(seed):
    ref_plan = gen_plan(np.random.default_rng(seed))
    port_plan = convert.from_reference(ref_plan)
    want = ref_oracle.execute_plan_rows(ref_plan)
    got = port_oracle.execute_plan_rows(port_plan)
    ok, msg = ref_oracle.rows_equal(
        [tuple(None if v is port.NULL else v for v in r) for r in got], want)
    assert ok, msg
    result = port.execute(port_plan, port.build_context("cpu"))
    ok, msg = port_oracle.rows_equal(result.to_host().to_rows(), got)
    assert ok, msg


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_row_oracle_on_semantics_cases(case):
    port_plan = convert.from_reference(SEMANTICS[case]())
    result = port.execute(port_plan, port.build_context("cpu"))
    ok, msg = port_oracle.rows_equal(
        result.to_host().to_rows(), port_oracle.execute_plan_rows(port_plan))
    assert ok, msg


def test_rows_equal_reports_a_difference():
    a = [(1, b"x", None), (2, b"y", 1.5)]
    assert port_oracle.rows_equal(a, list(reversed(a))) == (
        ref_oracle.rows_equal(a, list(reversed(a))))
    ok, msg = port_oracle.rows_equal(a, a[:1])
    assert not ok and msg == ref_oracle.rows_equal(a, a[:1])[1]
    ok, msg = port_oracle.rows_equal(a, [a[0], (2, b"z", 1.5)])
    assert not ok and msg == ref_oracle.rows_equal(
        a, [a[0], (2, b"z", 1.5)])[1]


def test_verify_result_catches_a_wrong_result(harness, sqlite):
    parsed, plan = harness.build_plan("q_or")
    good = port.execute(plan, harness.context)
    assert port_run.verify_result(parsed, plan, good, sqlite)[0]
    other = port.execute(harness.build_plan("q_alias")[1], harness.context)
    correct, detail = port_run.verify_result(parsed, plan, other, sqlite)
    assert not correct and detail


# ---------------------------------------------------------------------------
# the harness and its CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "shared", "stepwise"])
def test_cli_verifies_the_query_documents(mode, documents, capsys,
                                          monkeypatch):
    monkeypatch.setenv("RJT_EXEC_MODE", mode)
    rc = port_run.main([documents[0], "--scale", str(SCALE), "--platform",
                        "cpu", "--verify"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("Result correct: True") == len(DOCS)
    assert f"over {len(DOCS)} queries" in out


def test_cli_batch_and_runtime_file(documents, tmp_path, capsys):
    runtime = tmp_path / "runtime.txt"
    rc = port_run.main([documents[0], "q1a", "q_or", "q_varchar", "--scale",
                        str(SCALE), "--platform", "cpu", "--verify",
                        "--batch", "--repeat", "2", "--output-runtime",
                        str(runtime)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("Result correct: True") == 3
    assert "Batch wall-clock" in out
    assert int(runtime.read_text()) > 0


def test_cli_profile_writes_a_trace(documents, tmp_path, capsys):
    rc = port_run.main([documents[0], "q_alias", "--scale", str(SCALE),
                        "--platform", "cpu", "--profile",
                        str(tmp_path / "prof")])
    assert rc == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    capsys.readouterr()


class _Captured(Exception):
    pass


def _harness_settings(run_module, argv, monkeypatch):
    """``(distributed, dist_config)`` as ``run_module.main(argv)`` sets them
    on its harness, read at the first query (which then stops the run)."""
    seen = []

    class Recorder:
        distributed = False
        dist_config = None

        def __init__(self, *args, **kwargs):
            pass

        def run_query(self, name, **kwargs):
            seen.append((self.distributed, self.dist_config))
            raise _Captured

        def close(self):
            pass

    monkeypatch.setattr(run_module, "JobHarness", Recorder)
    with pytest.raises(_Captured):
        run_module.main(argv)
    return seen[0]


def test_cli_distributed_flags_parse_like_the_reference(documents, tmp_path,
                                                        monkeypatch):
    """Each combination of the --distributed flags gives the harness the
    same ``distributed`` switch and a ``DistJoinConfig`` equal field by
    field to the JAX CLI's; --batch and --distributed exclude each other
    in both."""
    import dataclasses

    base = [documents[0], "q1a", "--data-dir", str(tmp_path),
            "--platform", "cpu"]
    combos = [
        [],
        ["--distributed"],
        ["--distributed", "--dist-chunks", "3"],
        ["--distributed", "--dist-bloom-bits", "0"],
        ["--distributed", "--dist-feedback", "off"],
        ["--distributed", "--dist-chunks", "4", "--dist-bloom-bits", "8192",
         "--dist-feedback", "on"],
    ]
    for flags in combos:
        dist_p, cfg_p = _harness_settings(port_run, base + flags, monkeypatch)
        dist_r, cfg_r = _harness_settings(ref_run, base + flags, monkeypatch)
        assert dist_p == dist_r == ("--distributed" in flags)
        assert (cfg_p is None) == (cfg_r is None), flags
        if cfg_p is not None:
            assert [f.name for f in dataclasses.fields(cfg_p)] == [
                f.name for f in dataclasses.fields(cfg_r)]
            assert dataclasses.astuple(cfg_p) == dataclasses.astuple(cfg_r)
    for module in (port_run, ref_run):
        with pytest.raises(SystemExit):
            module.main(base + ["--batch", "--distributed"])


def test_harness_joins_a_launchers_group(documents, port_tables,
                                        monkeypatch):
    """RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT name the group the
    harness joins for --distributed (here one rank); it leaves it at close,
    and its results equal the single-card engine's."""
    import torch.distributed as dist

    from test_torch_dist import _free_port

    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(key, value)
    h = port_run.JobHarness(documents[0],
                            port_run.TableSource(host_tables=port_tables),
                            device="cpu")
    h.distributed = True
    try:
        res, _ms, _ok, _detail = h.run_query("q_alias")
        mesh = h.dist_mesh()
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
    finally:
        h.close()
    assert not dist.is_initialized()
    _parsed, plan = h.build_plan("q_alias")
    single = port.execute(plan, port.build_context("cpu"))
    ok, detail = port_oracle.rows_equal(port_rows(res), port_rows(single))
    assert ok, detail


def test_cli_distributed_run_on_the_cpu(documents, capsys):
    """--distributed with --platform cpu: a one-rank gloo group opened by
    the harness and left at its close; every result verified against the
    row oracle and sqlite, also on the warm repeat."""
    import torch.distributed as dist

    rc = port_run.main([documents[0], "q1a", "q_varchar", "--scale",
                        str(SCALE), "--platform", "cpu", "--verify",
                        "--distributed", "--repeat", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("Result correct: True") == 2
    assert not dist.is_initialized()


def test_cli_runs_on_the_card_by_default(documents):
    import torch

    argv = [documents[0], "q_alias", "--scale", str(SCALE)]
    if torch.cuda.is_available():
        assert port_run.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_run.main(argv)


def test_eager_pages_send_the_harness_through_the_paged_decode(
        documents, port_tables, sqlite, monkeypatch):
    """``RJT_EAGER_PAGES=on``: inputs are eager aligned pages without a host
    twin, so INT32 scan columns with a full page decode on the device, on
    the fused and on the wave executor."""
    from radixjoin_tpu_torch.ops import kernels

    monkeypatch.setenv("RJT_EAGER_PAGES", "on")
    calls = []
    plain = kernels.paged_window_gather_plain
    monkeypatch.setattr(kernels, "paged_window_gather_plain",
                        lambda b, i: calls.append(1) or plain(b, i))
    h = port_run.JobHarness(documents[0],
                            port_run.TableSource(host_tables=port_tables),
                            device="cpu")
    for mode in ("fused", "shared"):
        monkeypatch.setenv("RJT_EXEC_MODE", mode)
        del calls[:]
        _res, _ms, correct, detail = h.run_query("q6a", verify=True,
                                                 sqlite_oracle=sqlite)
        assert correct, detail
        assert calls, mode


def test_declined_query_document_is_served_by_the_wave_executor(
        harness, sqlite, monkeypatch):
    """The VARCHAR-key document: fused as a dev_csr over unified
    dictionary ids; when the fused structure declines it, ``auto`` mode
    hands it to ``execute_shared``."""
    from radixjoin_tpu_torch.plan import fused

    name = job_shapes.VARCHAR_KEY_QUERY
    parsed, plan = harness.build_plan(name)
    result = port.execute(plan, harness.context)
    assert "dev_csr" in "".join(
        plan._fused_struct_cache[1].strategies().values())
    monkeypatch.setattr(fused.FusedPlan, "_varchar_dev_csr",
                        lambda self, *a: None)
    calls = []
    run = port_exec.execute_shared
    monkeypatch.setattr(port_exec, "execute_shared",
                        lambda *a: calls.append(1) or run(*a))
    parsed, plan = harness.build_plan(name)
    declined = port.execute(plan, harness.context)
    assert calls == [1]
    assert port_run.verify_result(parsed, plan, declined, sqlite)[0]
    assert port_oracle.rows_equal(port_rows(declined), port_rows(result))[0]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def test_generator_without_queries_is_unchanged():
    """``queries=None``: bit for bit the tables the query-free generator
    gave, which are the JAX package's."""
    names = ["title", "cast_info", "role_type", "movie_keyword", "name"]
    got = port_datagen.SyntheticIMDB(scale=0.0004, seed=3).generate(names)
    want = ref_datagen.SyntheticIMDB(scale=0.0004, seed=3).generate(names)
    assert_same_tables(want, got)


def test_generator_with_queries_equals_reference(port_tables):
    assert_same_tables(_ref_tables(), port_tables)


def test_generate_cached_round_trips(tmp_path):
    cache = str(tmp_path / "cache")
    first = port_datagen.generate_cached(0.0004, 1, SQLS[:2], cache_dir=cache)
    assert len(os.listdir(cache)) == 1
    again = port_datagen.generate_cached(0.0004, 1, SQLS[:2], cache_dir=cache)
    assert_same_tables(first, again)
    assert_same_tables(first, port_datagen.SyntheticIMDB(
        scale=0.0004, seed=1, queries=SQLS[:2]).generate())


def test_literal_harvest_equal():
    got = port_datagen.LiteralHarvest().scan_queries(SQLS)
    want = ref_datagen.LiteralHarvest().scan_queries(SQLS)
    assert got.eq == want.eq and got.like == want.like
    assert got.numeric == want.numeric
    assert got.like[("movie_companies", "note")]
