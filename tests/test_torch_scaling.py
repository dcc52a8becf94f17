"""The port's distributed scaling bench
(radixjoin_tpu_torch/tools/scaling_bench.py) and the worker's
``bench_join`` scenario on gloo rank processes on the CPU: every size's
join total, and the plan mode's rows, equal a numpy count of the same
data; without a card and without ``--platform cpu`` the bench fails.
"""

import json
import os
import subprocess
import sys

import numpy as np

from radixjoin_tpu_torch.tools import scaling_bench
from radixjoin_tpu_torch.tools.multihost_worker import bench_join_inputs

from test_torch_dist import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _scaling(tmp_path, *args, **env):
    out = tmp_path / "scaling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.scaling_bench",
         "--platform", "cpu", "--ndev", "1,2", "--reps", "2",
         "--json", str(out), *args],
        cwd=REPO, env=_env(**env), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f), proc.stdout


def test_join_mode_totals_equal_numpy(tmp_path):
    rows = 4096
    results, stdout = _scaling(tmp_path, "--rows", str(rows), "--breakdown")
    assert [r["ndev"] for r in results] == [1, 2]
    for r in results:
        bk, bv, _bpl, pk, pv, _ppl = scaling_bench.make_join_data(
            r["ndev"], rows, 0.2)
        assert r["probe_rows"] == len(pk) == rows * r["ndev"]
        assert r["out_rows"] == int((pv & np.isin(pk, bk[bv])).sum())
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["s"] > 0 and 0 < r["weak_efficiency"]
        assert r["bytes_sent_per_dev"] > 0 and r["collective_calls"] > 0
        assert r["phase_exchange_ms"] > 0 and r["phase_expand_ms"] > 0
    assert "exchange" in stdout


def test_plan_mode_rows_equal_numpy(tmp_path):
    rows = 2048
    results, _stdout = _scaling(tmp_path, "--rows", str(rows),
                                "--mode", "plan")
    for r in results:
        n_fact = rows * r["ndev"]
        rng = np.random.default_rng(0)
        n_d1, n_d2 = max(256, n_fact // 16), max(64, n_fact // 64)
        rng.integers(0, n_d1, n_fact)  # dimension 1 keys: all present
        dim2 = rng.integers(0, n_d2 * 2, n_fact)
        assert r["out_rows"] == int((dim2 < n_d2).sum())


def test_bench_join_on_two_gloo_ranks_equals_numpy(tmp_path):
    n_probe = 1 << 15
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.multihost_worker",
         "--pid", str(r), "--nprocs", "2", "--port", str(port),
         "--device", "cpu", "--scenario", "bench_join",
         "--bench-rows", str(n_probe), "--repeats", "2",
         "--out", str(tmp_path / f"rank{r}.json")],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    record = json.loads((tmp_path / "rank0.json").read_text())
    assert (tmp_path / "rank1.json").read_text() == "OK\n"
    bk, bv, _bp, pk, pv, _pp = bench_join_inputs(n_probe)
    assert record["result_rows"] == int((pv & np.isin(pk, bk[bv])).sum())
    assert record["processes"] == 2 and record["backend"] == "gloo"
    assert record["probe_rows"] == n_probe and record["build_rows"] == len(bk)
    assert len(record["times_ms"]) == 2 and record["warmup_dropped"] == 2
    assert record["best_ms"] == min(record["times_ms"])


def test_without_a_card_it_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.scaling_bench",
         "--ndev", "1"], cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
