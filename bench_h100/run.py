"""Run one cell of the benchmark once, on the card it is started on.

    python bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` it measures for ``--seconds`` and reports the cell's
end-to-end metrics; with ``--trace 1`` it traces a bounded stretch of
requests under ``torch.profiler`` and reports the per-layer metrics.
Either way it checks a sample of the answers against the plain reference
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced), and last ``compared``, each number compared
beside its limit, which also closes standard error.  Without a CUDA card
(or with fewer than the cell asks for) it exits with code 2 and prints no
result; with JAX or the JAX package loaded, with code 3.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_h100 import harness
    spec = harness.Spec(args.workload, harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")))
    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the process holds {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = json.dumps(result)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
