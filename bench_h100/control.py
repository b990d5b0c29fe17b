"""The control of each cell's check: the computation in the nearest
precision below float32, put in the program's place, which the check has
to find wrong.  A cell's driver module may give its own control, as
``control_spec(spec) -> (spec, cell type)``; for a driver without one:

  * call cells: the program's own bfloat16 path (``dtype="bf16"``: values
    stored as bfloat16, x and the sums in float32; the path has no
    ``steal_mantissa`` or ``idx16``), packed and driven as the cell is;
  * query cells: the program has no bfloat16 min_plus path, so the plain
    reference runs in its place with its weights rounded to bfloat16 and
    its distances in float32.

    python bench_h100/control.py --workload <name> --seeds 1 2 3 [--seconds 2]

runs the control at the cell's own size, a short window on each seed, and
prints one JSON line a seed with the number compared and its limit.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_h100 import harness  # noqa: E402
from bench_h100.drivers import queries  # noqa: E402
from bench_h100.reference import sssp as ref_sssp  # noqa: E402


class Bf16Sssp(queries.Cell):
    """Queries answered by the reference in bfloat16 weights."""

    def prepare(self) -> None:
        self.graph = ref_sssp.Graph(self.csr, self.device, torch.float32)
        self.graph.w = self.graph.w.to(torch.bfloat16).to(torch.float32)

    def counters(self) -> dict:
        return {}

    def request(self, i: int):
        src = int(self.sources[i % len(self.sources)])
        d, enq, secs = self.watch.time(lambda: self.graph.distances(src))
        return (src, 1), d, 0, enq, secs

    def release(self) -> None:
        self.graph = None


def control_spec(spec: harness.Spec):
    """``(spec, cell type)`` of the cell's control: the driver's own
    ``control_spec`` where it has one, else the module doc's."""
    own = getattr(spec.driver(), "control_spec", None)
    if own is not None:
        return own(spec)
    spec = copy.copy(spec)
    if spec.traffic["driver"] == "queries":
        return spec, Bf16Sssp
    spec.config = copy.deepcopy(spec.config)
    spec.config["spmv_config"].update(dtype="bf16", steal_mantissa=False,
                                      idx16=False)
    return spec, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    spec, cell_type = control_spec(harness.Spec(
        args.workload, harness.load_json(os.path.join(ROOT,
                                                      "BENCHMARK.json"))))
    for seed in args.seeds:
        r = harness.run_cell(spec, seed, args.seconds, False, "cuda:0",
                             cell_type=cell_type)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": r["correct"],
                          "attempted": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
