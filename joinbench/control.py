"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one of the configurations'
guarantees broken (NULLs included: every NULL of a result comes back as a
value, 0 or the empty string), driven through the whole of a run. Its
``correct`` has to come out false, on every seed.

    python3 joinbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--device cpu --scale 0.001]

Each seed runs as a cell's run does (set-up, warm-up, the window, the
check), in this process, and prints one JSON line: the seed, ``correct``
and the numbers compared. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from joinbench import run  # noqa: E402


def plan_key(plan) -> str:
    """A plan's shape and its inputs' row counts: the same for a plan and
    its fresh copies, different between the plans of a configuration."""
    return repr(([(n.data, n.output_attrs) for n in plan.nodes], plan.root,
                 [t.num_rows for t in plan.inputs]))


def null_as_value(columns):
    """The guarantee broken: NULLs written as values."""
    return [(t, v, valid | True) for t, v, valid in columns]


def paged(columns, num_rows: int):
    """A paged ``ColumnarTable`` of ``(type name, values or (heap, ends),
    valid)`` columns, as ``execute`` would return it."""
    from radixjoin_tpu_torch import ColumnarTable, DataType
    from radixjoin_tpu_torch.storage.columnar import HostColumn, HostTable

    cols = []
    for type_name, values, valid in columns:
        if type_name == "VARCHAR":
            cols.append(HostColumn.varchar(*values, valid))
        else:
            dt = DataType[type_name]
            cols.append(HostColumn(dt, values.astype(dt.numpy_dtype), valid))
    table = ColumnarTable.from_host(HostTable(num_rows, cols))
    return ColumnarTable(table.num_rows, table.columns)


def reference_in_place(cell_cls, device, damage=null_as_value):
    """A Cell class whose runs hand ``radixjoin_tpu_torch.execute``'s calls
    to the reference, with ``damage`` applied to each result; and the
    function that undoes the patch."""
    import radixjoin_tpu_torch as rjt

    state = {"tables": None, "names": {}}

    class ControlCell(cell_cls):
        def __init__(self, root, name):
            super().__init__(root, name)
            generate, build = self.config.generate, self.config.build_plans

            def gen(seed, **kwargs):
                state["tables"] = generate(seed, **kwargs)
                return state["tables"]

            def plans(tables, *args):
                out = build(tables, *args)
                state["names"] = {plan_key(p): n for n, p in out.items()}
                return out

            self.config.generate, self.config.build_plans = gen, plans
            state["reference"] = self.reference

    original = rjt.execute

    def execute(plan, _context=None):
        name = state["names"][plan_key(plan)]
        rel, columns = state["reference"].result(name, state["tables"], device)
        table = paged(damage(rel.values(columns)), len(rel))
        return table

    rjt.execute = execute

    def undo():
        rjt.execute = original

    return ControlCell, undo


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=float, default=None)
    args = parser.parse_args(argv)
    cell_cls, undo = reference_in_place(run.Cell, args.device)
    run.Cell = cell_cls
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = run.run_cell(ROOT, args.workload, seed, args.seconds, False,
                               device=args.device, scale=args.scale)
            print(json.dumps({"seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "checks": out["checks"]}), flush=True)
    finally:
        undo()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
