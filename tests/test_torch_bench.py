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

from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.002
DETAIL_KEYS = {"queries", "result_rows", "scaled_baseline_ms", "backend",
               "slowest", "batch_wall_ms", "warmup_phase_s",
               "stage_split_ms", "degradations", "launches"}


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
    assert set(detail["warmup_phase_s"]) == {"warmup-exec1", "warmup-exec2"}


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
    assert tags == ["bench[mem] datagen", "bench[mem] warmup-exec1",
                    "bench[mem] warmup-exec2", "bench[mem] pass 0"]
    assert any("pyheap=" in ln for ln in proc.stderr.splitlines())
