"""The benchmark of the PyTorch / CUDA port, one cell a run.

    python3 xcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the card this process finds (it never falls back to the CPU),
prints each number compared beside its limit on standard error and, as its
last line on standard output, one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from xcbench import harness
    t_imports = time.perf_counter()

    bench = harness.benchmark()
    wl = next((w for w in bench["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        harness.log(f"no workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        harness.log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda:0")  # the CUDA context, timed on its own
    marks = dict(imports=t_imports, context=time.perf_counter())
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T_START, marks)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process, and not allowed: {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
