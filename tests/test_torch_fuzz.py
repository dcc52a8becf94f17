"""Randomized plans through the port and the JAX package: every key dtype,
NULL keys and payloads, duplicate keys, empty inputs, type-mismatched keys,
both build sides, multi-join trees and random projections; plans whose
reference takes the merge join (FP64 keys, sparse key windows) run it in
the port too. Seeds 0-9 cover the csr, csr_swapped, dev_csr,
dev_csr_swapped, empty and merge lowerings between them.

The port's own generator (radixjoin_tpu_torch/harness/fuzz.py, which the
fuzz campaign runs) gives the JAX test's plan for a seed, and the campaign
itself runs here on the CPU in every mode.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import radixjoin_tpu as ref
import radixjoin_tpu_torch as port
from radixjoin_tpu_torch.harness import fuzz
from radixjoin_tpu_torch.harness import oracle as port_oracle
from radixjoin_tpu_torch.tools import fuzz_campaign

from test_fuzz_plans import gen_plan
from test_torch_engine import check_parity, port_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NULLS = (ref.NULL, port.NULL)


def _plan_content(plan):
    """A plan as plain values: inputs (column types, rows), nodes (fields,
    output attributes with types as ints), root."""
    def types(attrs):
        return [(int(a), int(t)) for a, t in attrs]

    inputs = []
    for table in plan.inputs:
        host = table.to_host()
        inputs.append(([int(c.dtype) for c in host.columns],
                       fuzz.mask_nan([tuple(None if v in NULLS else v
                                            for v in row)
                                      for row in host.to_rows()])))
    nodes = []
    for node in plan.nodes:
        data = node.data
        fields = (("join", data.build_left, data.left, data.right,
                   data.left_attr, data.right_attr)
                  if node.is_join else ("scan", data.base_table_id))
        nodes.append((fields, types(node.output_attrs)))
    return inputs, nodes, plan.root


@pytest.mark.parametrize("seed", range(20))
def test_port_generator_gives_the_reference_plan(seed):
    want = _plan_content(gen_plan(np.random.default_rng(seed)))
    got = _plan_content(fuzz.gen_plan(np.random.default_rng(seed)))
    assert got == want


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_plan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    converted = check_parity(gen_plan(rng))
    # the port's own plan of the seed: the rows and strategies of the plan
    # carried over from the reference, which check_parity held to it
    own = fuzz.gen_plan(np.random.default_rng(seed))
    ctx = port.build_context("cpu")
    want = port_rows(port.execute(converted, ctx))
    for _run in range(2):
        got = port_rows(port.execute(own, ctx))
        ok, msg = port_oracle.rows_equal(got, want)
        assert ok, msg
    assert (own._fused_struct_cache[1].strategies()
            == converted._fused_struct_cache[1].strategies())
    assert own._last_join_totals == converted._last_join_totals


def test_campaign_is_clean_in_every_mode():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RJT_")}
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.fuzz_campaign",
         "--platform", "cpu", "--seeds", "8",
         "--modes", "auto,shared,stepwise,spill,dist,dist_chunked"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "FAIL" not in proc.stdout
    # 8 seeds: one run in each of four modes, cold and warm in two
    assert "CLEAN (64 checked runs" in proc.stdout


def test_campaign_reports_a_planted_wrong_result(monkeypatch, capsys):
    real = port_oracle.execute_plan_rows
    monkeypatch.setattr(port_oracle, "execute_plan_rows",
                        lambda plan: real(plan) + [(b"planted",)])
    rc = fuzz_campaign.main(["--platform", "cpu", "--seeds", "2",
                             "--modes", "auto,spill"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL seed=0 mode=auto:" in out and "FAIL seed=1 mode=spill:" in out
    assert "4 FAILURES" in out


def test_campaign_without_a_card_fails():
    env = {k: v for k, v in os.environ.items() if not k.startswith("RJT_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.fuzz_campaign",
         "--seeds", "1"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
