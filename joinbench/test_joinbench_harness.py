"""The harness on the CPU at a small scale: the result line, the traffic's
fresh inputs, a cell found from new files alone, and the command's refusal
without a card. The measured path runs only on the card; these tests reach
the rest through ``run.run_cell(..., device="cpu", scale=...)``."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from joinbench import run

ROOT = run.ROOT
CELLS = ["job5_sf1.resident_small_roots", "joingraph_sf1.resident"]
BIG_SEED = 2 ** 31 + 987654321


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    out = run.run_cell(ROOT, cell, BIG_SEED, 0.3, bool(trace), device="cpu",
                       scale=0.001)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    manifest = _manifest()
    kind = "per_layer" if trace else "end_to_end"
    declared = {m["name"]: m for m in manifest[kind]
                if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= set(declared)
    for name, m in out["metrics"].items():
        assert m["unit"] == declared[name]["unit"]
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the host-side readers find their numbers on any device
        host_side = {n for n, m in declared.items()
                     if m["source"] != "device_trace"}
        assert host_side and host_side <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == set(declared)
    json.dumps(out)


def root_with_fresh_cell(tmp_path):
    """A copy of the benchmark whose manifest also has ``job5_sf1.fresh``
    (``job5_imdb_sf1`` under ``serial_fresh``), the cell kept out of
    ``BENCHMARK.json`` until the program's ledger race is mended."""
    shutil.copytree(os.path.join(ROOT, "joinbench"), tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = _manifest()
    manifest["workloads"].append({"name": "job5_sf1.fresh",
                                  "config": "job5_imdb_sf1",
                                  "traffic": "serial_fresh", "chips": 1,
                                  "why": "new paged inputs each request"})
    manifest["per_layer"].append({"name": "upload.device_ms", "unit": "ms",
                                  "better": "lower", "source": "device_trace",
                                  "layer": "upload and device page decode",
                                  "moves": "queries_per_s",
                                  "workloads": ["job5_sf1.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(tmp_path)


@pytest.mark.parametrize("trace", [0, 1])
def test_fresh_mix(tmp_path, trace):
    """The fresh mix runs and checks on the CPU: every request a new plan."""
    out = run.run_cell(root_with_fresh_cell(tmp_path), "job5_sf1.fresh",
                       BIG_SEED, 0.3, bool(trace), device="cpu", scale=0.001)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % 5 == 0


def test_seed_gives_same_data():
    from joinbench.configs import joingraph_imdb_sf1 as cfg

    a = cfg.generate(BIG_SEED, scale=0.001)
    b = cfg.generate(BIG_SEED, scale=0.001)
    c = cfg.generate(BIG_SEED + 1, scale=0.001)
    ca, cb, cc = (t["cast_info"].columns[2].values for t in (a, b, c))
    assert np.array_equal(ca, cb) and not np.array_equal(ca, cc)


def test_fresh_copy_shares_pages():
    from joinbench.configs import job5_imdb_sf1 as cfg

    plans = cfg.build_plans(cfg.generate(5, scale=0.001))
    for plan in plans.values():
        copy = run.fresh_copy(plan)
        assert copy is not plan and copy.root == plan.root
        assert [n.data for n in copy.nodes] == [n.data for n in plan.nodes]
        for t_new, t_old in zip(copy.inputs, plan.inputs):
            assert t_new is not t_old and t_new._host is None
            for c_new, c_old in zip(t_new.columns, t_old.columns):
                assert c_new is not c_old
                assert c_new.pages is c_old.pages  # the bytes, not a copy


def test_new_cell_found_from_new_files(tmp_path):
    """A configuration, a mix with a driver of its own, an end-to-end and a
    per-layer metric added as files and entries of a copy, with no file
    edited, run as a cell of the copy."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "joinbench"), root / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "joinbench"
    shutil.copy(bench / "configs" / "joingraph_imdb_sf1.py",
                bench / "configs" / "tiny_graph.py")
    shutil.copy(bench / "reference" / "joingraph_imdb_sf1.py",
                bench / "reference" / "tiny_graph.py")
    # new behaviour: each plan three times back to back, one warm-up pass
    (bench / "drivers" / "bursts.py").write_text(
        "def warm_up(session, traffic):\n"
        "    for name in session.names:\n"
        "        session.warm(name)\n"
        "    return {'warmup_once_s': 0.0}\n\n\n"
        "def window(session, traffic):\n"
        "    while not session.over():\n"
        "        for name in session.names:\n"
        "            for _ in range(traffic['burst']):\n"
        "                session.call(name)\n")
    (bench / "traffic" / "bursts_s1_s3.json").write_text(json.dumps(
        {"why": "a test", "driver": "bursts", "inputs": "fresh",
         "plans": ["S1", "S3"], "burst": 3}))
    (bench / "metrics" / "requests.count.py").write_text(
        "def read(rec):\n    return float(len(rec.requests))\n")
    (bench / "end_to_end" / "query_max_ms.py").write_text(
        "def read(window):\n    return max(window.times_ms)\n")
    manifest = _manifest()
    manifest["configs"].append({"name": "tiny_graph", "source": "a test",
                                "file": "joinbench/configs/tiny_graph.py",
                                "reduced": []})
    manifest["workloads"].append({"name": "tiny.cell", "config": "tiny_graph",
                                  "traffic": "bursts_s1_s3", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({"name": "query_max_ms", "unit": "ms",
                                   "better": "lower", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": ["tiny.cell"]})
    manifest["per_layer"].append({"name": "requests.count", "unit": "requests",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "test", "moves": "queries_per_s",
                                  "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    traced = run.run_cell(str(root), "tiny.cell", 3, 0.2, True, device="cpu",
                          scale=0.001)
    assert traced["correct"] is True
    assert traced["metrics"]["requests.count"]["value"] == traced["attempted"]
    assert traced["attempted"] % 6 == 0
    assert "warmup_once_s" in traced["setup_split_s"]
    out = run.run_cell(str(root), "tiny.cell", 3, 0.2, False, device="cpu",
                       scale=0.001)
    assert out["correct"] is True
    assert {"setup_s", "queries_per_s", "peak_device_gib",
            "query_max_ms"} <= set(out["metrics"])
    assert out["metrics"]["query_max_ms"]["value"] > 0


def test_a_mix_naming_a_plan_the_configuration_lacks_is_refused(tmp_path):
    shutil.copytree(os.path.join(ROOT, "joinbench"), tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "joinbench" / "traffic" / "bad.json").write_text(json.dumps(
        {"why": "a test", "driver": "closed_loop", "inputs": "resident",
         "plans": ["S1", "S9"], "warmup_passes": 1}))
    manifest = _manifest()
    manifest["workloads"].append({"name": "bad.cell",
                                  "config": "joingraph_imdb_sf1",
                                  "traffic": "bad", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="S9"):
        run.Cell(str(tmp_path), "bad.cell")


def test_no_result_once_jax_has_come_in(tmp_path):
    """A per-layer reader, loaded after the window has closed, that imports
    a module named ``jax``: the command exits non-zero and prints no
    result. The card and the check are stood in for on the CPU."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "joinbench"), root / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("LOADED = True\n")
    (root / "joinbench" / "metrics" / "jax.reader.py").write_text(
        "import jax\n\n\ndef read(rec):\n    return 1.0\n")
    manifest = _manifest()
    manifest["per_layer"].append({"name": "jax.reader", "unit": "x",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "test", "moves": "queries_per_s",
                                  "workloads": ["joingraph_sf1.resident"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    script = (
        "import sys, torch\n"
        "from joinbench import run\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "cpu_run = run.run_cell\n"
        "run.run_cell = lambda root, w, seed, s, trace: cpu_run(\n"
        "    root, w, seed, s, trace, device='cpu', scale=0.001)\n"
        "sys.exit(run.main(['--workload', 'joingraph_sf1.resident', '--seed',\n"
        "                   '5', '--seconds', '0.2', '--trace', '1']))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), ROOT, str(stub), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=root,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""
    assert "forbidden modules loaded: ['jax']" in proc.stderr


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", "job5_sf1.resident_small_roots",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and joinbench/, the
    command exits non-zero and prints no result."""
    shutil.copytree(os.path.join(ROOT, "joinbench"), tmp_path / "joinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", "job5_sf1.resident_small_roots",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of each cell on the card, by the command line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload", cell, "--seed",
         str(BIG_SEED), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
