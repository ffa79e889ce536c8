"""The readings the limits of ``correct`` are set from, on the card.

    python3 xcbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For each seed: the cell's set-up, a short window at the cell's own load,
and each kept answer's gaps to the float64 reference (the program's
readings, the worst of its samples).  For each control seed the control:
the reference itself computed in bfloat16, the nearest precision below
the configuration's float32, in the program's place, on the same inputs.
One JSON line a reading, then a summary: per number the program's largest
reading, the control's smallest, and their ratio.  The benchmark's own runs
never run this.
"""

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(workload, seeds, control_seeds, seconds, device, out):
    import torch
    from xcbench import compare, harness
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = harness.context(workload, seed, device)
        st = ctx.driver.setup(ctx)
        win = harness.measure(ctx, st, seconds)
        kept = win.pop("kept")
        ctx.driver.release(st)
        if seed in seeds:
            emit(dict(seed=seed, kind="program", steps=win["steps"],
                      readings=compare.worst(ctx.driver.check(st, kept))))
        if seed in control_seeds:
            try:
                r = compare.worst(ctx.driver.check(st, kept[:1],
                                                   torch.bfloat16))
            except (RuntimeError, TypeError, NotImplementedError) as e:
                r = {"error": f"{type(e).__name__}: {e}"[:300]}
            emit(dict(seed=seed, kind="control", readings=r))
        ctx.driver.close(st)
        shutil.rmtree(ctx.tmp, ignore_errors=True)
        del st
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    prog = [r["readings"] for r in rows if r["kind"] == "program"]
    ctrl = [r["readings"] for r in rows if r["kind"] == "control"
            and "error" not in r["readings"]]
    summary = {}
    for k in (prog or ctrl)[0]:
        lo = max(r[k] for r in prog) if prog else None
        up = min(r[k] for r in ctrl) if ctrl else None
        summary[k] = dict(lower=lo, upper=up,
                          ratio=up / lo if lo and up is not None else None)
    emit(dict(kind="summary", workload=workload, summary=summary))
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    a = ap.parse_args()
    ints = lambda s: [int(x) for x in s.split(",") if x]
    t = time.perf_counter()
    readings(a.workload, ints(a.seeds), ints(a.control_seeds), a.seconds,
             a.device, a.out)
    print(f"[control] {a.workload}: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
