"""What a run loads: no JAX and no JAX package in the process that prints
the result (top-level module names compared whole: the port's name begins
with the JAX package's), and a plain reference that loads nothing of the
program."""

import json
import subprocess
import sys

from joinbench import run

ROOT = run.ROOT


def _python(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    out = _python(
        "import json, sys\n"
        "from joinbench import run\n"
        "for cell in ('job5_sf1.resident_small_roots', 'joingraph_sf1.resident'):\n"
        "    run.run_cell(run.ROOT, cell, 7, 0.2, True, device='cpu', scale=0.001)\n"
        "print(json.dumps([run.forbidden_modules(),\n"
        "                  'radixjoin_tpu_torch' in sys.modules]))\n")
    forbidden, port_loaded = json.loads(out)
    assert forbidden == [] and port_loaded


def test_the_check_compares_whole_top_level_names():
    out = _python(
        "import json, sys, types\n"
        "from joinbench import run\n"
        "import radixjoin_tpu_torch\n"
        "before = run.forbidden_modules()\n"
        "sys.modules['radixjoin_tpu.engine'] = types.ModuleType('x')\n"
        "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
        "print(json.dumps([before, run.forbidden_modules()]))\n")
    before, after = json.loads(out)
    assert before == [] and after == ["jaxlib", "radixjoin_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    out = _python(
        "import json, os, sys\n"
        "from joinbench import run\n"
        "for name in ('job5_imdb_sf1', 'joingraph_imdb_sf1'):\n"
        "    run.load_module(os.path.join(run.HERE, 'reference', name + '.py'),\n"
        "                    'ref_' + name)\n"
        "from joinbench import digest, pagefmt, relops  # noqa: F401\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}\n"
        "                        & {'radixjoin_tpu_torch', 'radixjoin_tpu',\n"
        "                           'jax', 'jaxlib'})))\n")
    assert json.loads(out) == []
