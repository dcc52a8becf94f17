"""The port's bench (``python -m radixjoin_tpu_torch.bench``) on the CPU:
``BENCH_PLATFORM=cpu`` over the built-in query documents at a small scale.
It prints exactly one JSON line with the JAX bench's fields, no
degradation, and as many result rows as the JAX package's ``JobHarness``
gives for the same documents at the same scale and seed. Without the CPU
request and without a card, and without query files, it exits non-zero.
"""

import json
import os
import subprocess
import sys

import pytest

from radixjoin_tpu.harness import datagen as ref_datagen
from radixjoin_tpu.harness import run as ref_run

from radixjoin_tpu_torch import bench
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.002
DETAIL_KEYS = {"queries", "result_rows", "scaled_baseline_ms", "backend",
               "slowest", "batch_wall_ms", "warmup_phase_s",
               "stage_split_ms", "degradations", "launches", "feedback"}


def _run_bench(**env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("BENCH_", "RJT_"))}
    full.update(env)
    return subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.bench"], cwd=REPO,
        env=full, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cpu_run():
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_PLANS="builtin",
                      BENCH_SCALE=str(SCALE), BENCH_REPEAT="1",
                      BENCH_SECONDARY_SCALE="")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_one_json_line_with_the_reference_fields(cpu_run):
    lines = cpu_run.stdout.splitlines()
    assert len(lines) == 1, cpu_run.stdout
    out = json.loads(lines[0])
    assert out["metric"] == f"job5_synthetic_sf{SCALE}_total_ms"
    assert out["unit"] == "ms" and out["value"] > 0
    assert out["vs_baseline"] is None  # not the 113-query suite
    detail = out["detail"]
    assert DETAIL_KEYS <= set(detail), sorted(detail)
    assert detail["backend"] == "cpu" and detail["queries"] == 5
    assert "device_ms" not in detail  # the card's stage only
    assert "secondary" not in detail and "partial" not in detail
    assert sorted(n for n, _ms in detail["slowest"]) == sorted(
        job_shapes.QUERY_DOCUMENTS)
    assert detail["degradations"]["queries"] == {}
    assert not any(v for k, v in detail["degradations"].items()
                   if k != "queries")
    assert list(detail["warmup_phase_s"]) == [
        "precompile", "warmup-exec1", "precompile-feedback", "warmup-exec2"]


def test_result_rows_equal_the_jax_harness(cpu_run, tmp_path):
    docs = job_shapes.QUERY_DOCUMENTS
    plans = job_shapes.write_query_documents(str(tmp_path))
    tables = ref_datagen.SyntheticIMDB(
        scale=SCALE, seed=0, queries=[docs[n][0] for n in docs]).generate()
    harness = ref_run.JobHarness(
        plans, ref_run.TableSource(host_tables=tables),
        os.path.join(str(tmp_path), "job"))
    want = sum(harness.run_query(name)[0].num_rows for name in docs)
    got = json.loads(cpu_run.stdout)["detail"]["result_rows"]
    assert got == want > 0


def test_without_a_card_it_fails_naming_the_card():
    proc = _run_bench(BENCH_PLANS="builtin", BENCH_SCALE=str(SCALE),
                      CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_default_query_files_absent_fails(tmp_path):
    # BENCH_PLANS has no default: the JOB suite's files are not in the
    # repository
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_SCALE=str(SCALE))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "BENCH_PLANS is not set" in proc.stderr
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_SCALE=str(SCALE),
                      BENCH_PLANS=str(tmp_path / "plans.json"))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "query files not found" in proc.stderr


def test_launch_counts_and_host_memory_profile():
    # one query, no bonus stage: the launch counts of the warm-up and the
    # timed pass are in detail, and BENCH_RSS_PROFILE=1 logs a host memory
    # snapshot a phase
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_PLANS="builtin",
                      BENCH_SCALE=str(SCALE), BENCH_REPEAT="1",
                      BENCH_QUERIES="q_alias", BENCH_BATCH="off",
                      BENCH_RSS_PROFILE="1")
    assert proc.returncode == 0, proc.stderr[-3000:]
    detail = json.loads(proc.stdout)["detail"]
    assert detail["queries"] == 1 and "batch_wall_ms" not in detail
    # on the CPU every wrapper takes its plain version: no launch
    assert detail["launches"] == {k: 0 for k in kernels.launch_counts()}
    tags = [ln.split(":")[0] for ln in proc.stderr.splitlines()
            if ln.startswith("bench[mem] ") and "rss=" in ln]
    assert tags == ["bench[mem] datagen", "bench[mem] precompile",
                    "bench[mem] warmup-exec1",
                    "bench[mem] precompile-feedback",
                    "bench[mem] warmup-exec2", "bench[mem] pass 0"]
    assert any("pyheap=" in ln for ln in proc.stderr.splitlines())


def test_feedback_store_defaults_to_the_bench_cache(cpu_run):
    feedback = json.loads(cpu_run.stdout)["detail"]["feedback"]
    assert feedback["path"] == os.path.join(REPO, ".bench_cache",
                                            "rjt_feedback.json")
    assert feedback["plans"] == 5 and 0 <= feedback["loaded"] <= 5
    assert f"bench: feedback store {feedback['path']}: " in cpu_run.stderr


def test_second_run_loads_every_plan_from_the_store(tmp_path):
    """Two bench processes over one store: the first finds nothing in it
    and saves every plan, the second loads every plan; both warm in the
    four phases of the pools and give the same rows."""
    common = dict(BENCH_PLATFORM="cpu", BENCH_PLANS="builtin",
                  BENCH_SCALE=str(SCALE), BENCH_REPEAT="1",
                  BENCH_SECONDARY_SCALE="", BENCH_BATCH="off",
                  RJT_FEEDBACK_PATH=str(tmp_path / "fb.json"))
    first = _run_bench(**common)
    second = _run_bench(**common)
    for proc in (first, second):
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"warmup-exec1 ({bench.POOL_THREADS} threads)" in proc.stderr
    a = json.loads(first.stdout)["detail"]
    b = json.loads(second.stdout)["detail"]
    assert a["result_rows"] == b["result_rows"] > 0
    assert a["feedback"]["loaded"] == 0 and b["feedback"]["loaded"] == 5
    for d in (a, b):
        assert list(d["warmup_phase_s"]) == [
            "precompile", "warmup-exec1", "precompile-feedback",
            "warmup-exec2"]
    assert len(json.loads((tmp_path / "fb.json").read_text())) == 5


def test_empty_feedback_path_switches_the_store_off(tmp_path):
    """An empty ``RJT_FEEDBACK_PATH`` is kept (not replaced by the bench's
    default) and turns the store off."""
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_PLANS="builtin",
                      BENCH_SCALE=str(SCALE), BENCH_REPEAT="1",
                      BENCH_SECONDARY_SCALE="", BENCH_BATCH="off",
                      RJT_FEEDBACK_PATH="")
    assert proc.returncode == 0, proc.stderr[-3000:]
    feedback = json.loads(proc.stdout)["detail"]["feedback"]
    assert feedback == {"path": None, "loaded": 0, "plans": 5}
    assert "bench: feedback store None: 0 of 5 plans" in proc.stderr


def test_a_failing_warm_up_thread_fails_the_bench(tmp_path):
    # an unknown executor mode makes every execute raise in the pool
    proc = _run_bench(BENCH_PLATFORM="cpu", BENCH_PLANS="builtin",
                      BENCH_SCALE=str(SCALE), RJT_EXEC_MODE="bogus",
                      RJT_FEEDBACK_PATH=str(tmp_path / "fb.json"))
    assert proc.returncode == 4
    assert (f"bench: warmup-exec1 ({bench.POOL_THREADS} threads) failed: "
            "ValueError") in proc.stderr
    detail = json.loads(proc.stdout)["detail"]
    assert detail["partial"] == "watchdog fired during warmup-exec1"
