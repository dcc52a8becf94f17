"""Randomized plans (tests/test_fuzz_plans.py::gen_plan) through the port
and the JAX package: every key dtype, NULL keys and payloads, duplicate
keys, empty inputs, type-mismatched keys, both build sides, multi-join
trees and random projections; plans whose reference takes the merge
join (FP64 keys, sparse key windows) run it in the port too. Seeds 0-9
cover the csr, csr_swapped, dev_csr, dev_csr_swapped, empty and merge
lowerings between them.
"""

import numpy as np
import pytest

from test_fuzz_plans import gen_plan
from test_torch_engine import check_parity


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_plan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    check_parity(gen_plan(rng))
