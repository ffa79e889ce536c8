#!/usr/bin/env python3
"""Time the design options of K7 and K8 on one card.

    python3 scripts/length_variants.py [--parent DIR] [--out DIR]

Each option is this checkout's K7 and K8 sources
(``xcontour_tpu_torch/csrc/length.cu`` and ``length.cuh``) with one change
made by text substitution, in a copy of the package under
``build/length_variants/<option>`` that builds its own kernels; each runs
in its own process, which times the K7 and K8 cases of this checkout's
``chip_smoke.length_cases`` (ERA5 at N = 121 and 401, the headline
Cartesian field, one ERA5 level in windows of 101 / 10 and
``K8_WINDOWS``): CUDA events over back-to-back wrapper calls, and the device
time of each CUDA kernel from torch.profiler.  The options:

  final             the design as committed
  one_copy          K7: every lane adds into one copy of a tile's totals
  k7_thread_search  K7: the tile's range of levels by a binary search,
                    not a 32-way search of warp 0's lanes
  k7_plain_search   K7: each cell's count of a chunk's levels by a binary
                    search, not guessed from even spacing and checked
  k8_staged         K8: a warp stages its block's coordinates in shared
                    memory, not reading them through L1
  no_register_cap   K7 and K8: the compiler's register count (no minimum
                    of 4 blocks an SM)
  k8_no_pretest     K8: every window covering a block classifies its cells
  k8_one_slab, k8_slab_4, k8_slab_16
                    K8: one warp a lattice block, or slabs of 4 or 16 steps
                    of 32 cells a warp, not 8
  k8_steps_1, k8_steps_4
                    K8: a lane holds 1 or 4 steps of cells, not 2

With ``--parent DIR`` (a checkout of the parent commit) it also times the
parent's kernels.  Every option's outputs must equal the final design's
bit for bit (integer sums); the parent's agree within K7's and K8's
bound.  It exits non-zero if a run fails.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRCS = ("xcontour_tpu_torch/csrc/length.cu",
        "xcontour_tpu_torch/csrc/length.cuh")

# a warp's block coordinates into shared memory, for a stride of at most 64
STAGE = """\
  if (s <= 64) {
    for (int i = lane; i <= s; i += 32) {
      sy[warp][i] = i <= h ? ys[i] : 0.f;
      sx[warp][i] = i <= wd ? xs[i] : 0.f;
    }
    __syncwarp();
    ys = sy[warp];
    xs = sx[warp];
  }
"""

OPTIONS = {
    "final": [],
    "one_copy": [("        ncopy = min(32, kAccWords / cnt);",
                  "        ncopy = 1;")],
    "k7_thread_search": [
        ("    const int a0 = warp_count_below(lb, N, tlo);\n"
         "    const int a1 = max(a0, warp_count_below(lb, N, thi));",
         "    const int a0 = count_below(lb, N, tlo);\n"
         "    const int a1 = max(a0, count_below(lb, N, thi));")],
    "k7_plain_search": [
        ("        a[i] = count_below_guess(slev, cnt, lo[i], l0, inv);\n"
         "        m[i] = count_below_guess(slev, cnt, hi[i], l0, inv) - a[i];",
         "        a[i] = count_below(slev, cnt, lo[i]);\n"
         "        m[i] = count_below(slev, cnt, hi[i]) - a[i];")],
    "k8_staged": [
        ("  __shared__ float ql[kWarps][kWQ];\n",
         "  __shared__ float ql[kWarps][kWQ];\n"
         "  __shared__ float sy[kWarps][65], sx[kWarps][65];\n"),
        ("  const float* xs = xcoord + c0;\n",
         "  const float* xs = xcoord + c0;\n" + STAGE)],
    "no_register_cap": [("constexpr int kMinBlocks = 4;",
                         "constexpr int kMinBlocks = 1;")],
    "k8_no_pretest": [
        ("    if (!(glo < ghi)) continue;  // no level crosses these cells",
         "    if (glo != glo) continue;"),
        ("__ballot_sync(kFull, glo <= lw && lw < ghi)",
         "__ballot_sync(kFull, !isnan(lw))")],
    "k8_one_slab": [("constexpr int kSlabSteps = 8;",
                     "constexpr int kSlabSteps = 1 << 20;")],
    "k8_slab_4": [("constexpr int kSlabSteps = 8;",
                   "constexpr int kSlabSteps = 4;")],
    "k8_slab_16": [("constexpr int kSlabSteps = 8;",
                    "constexpr int kSlabSteps = 16;")],
    "k8_steps_1": [("constexpr int kCellSteps = 2;",
                    "constexpr int kCellSteps = 1;")],
    "k8_steps_4": [("constexpr int kCellSteps = 2;",
                    "constexpr int kCellSteps = 4;")],
}
PARENT_OPTIONS = {"parent": []}

# run from a variant's root: argv[1] this checkout's chip_smoke.py, argv[2]
# the option's name, argv[3] where to save its outputs
PROBE = r"""
import importlib.util, sys, torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import xcontour_tpu_torch as xt
lat, lon, pv = cs.make_pv(cs.ERA5["B"], cs.ERA5["nlat"], cs.ERA5["nlon"], 0)
grid = xt.from_latlon(lat, lon, device="cuda")
q = torch.as_tensor(pv).to("cuda")
_, _, hpv = cs.make_pv(cs.HEADLINE["B"], cs.HEADLINE["nlat"],
                       cs.HEADLINE["nlon"], 100)
hq = torch.as_tensor(hpv).to("cuda")
outs = {}
for case, c in cs.length_cases(q, grid, hq).items():
    kern = c[1]
    outs[case] = kern().cpu()
    ms = cs.cuda_ms(kern, 50)
    split = cs.device_split(kern, 20)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
    print(f"option {sys.argv[2]} {case}: wrapper {ms:.4f} ms, device "
          f"{sum(split.values()):.4f} ms ({parts})", flush=True)
torch.save(outs, sys.argv[3])
"""


def variant(name: str, src_root: Path, subs, base: Path) -> Path:
    """A copy of src_root's package with the substitutions made."""
    dst = base / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src_root / "xcontour_tpu_torch", dst / "xcontour_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    texts = {src: (dst / src).read_text() for src in SRCS}
    for old, new in subs:
        holders = [src for src, text in texts.items() if old in text]
        if not holders:
            raise SystemExit(f"{name}: {old!r} not in {', '.join(SRCS)}")
        for src in holders:
            texts[src] = texts[src].replace(old, new)
    for src, text in texts.items():
        (dst / src).write_text(text)
    return dst


def main() -> int:
    import torch
    args = sys.argv[1:]
    base = ROOT / "build" / "length_variants"
    parent = None
    if "--out" in args:
        i = args.index("--out")
        base = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    if args:
        print(__doc__, file=sys.stderr)
        return 2
    base.mkdir(parents=True, exist_ok=True)
    runs = [(n, ROOT, s) for n, s in OPTIONS.items()]
    if parent is not None:
        runs += [(n, parent, s) for n, s in PARENT_OPTIONS.items()]
    outs = {}
    for name, src_root, subs in runs:
        root = variant(name, src_root, subs, base)
        saved = base / f"{name}.pt"
        proc = subprocess.run([sys.executable, "-c", PROBE,
                               str(ROOT / "chip_smoke.py"), name, str(saved)],
                              cwd=root, capture_output=True, text=True)
        (base / f"{name}.log").write_text(proc.stdout + proc.stderr)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        outs[name] = torch.load(saved)
    final = outs["final"]
    for name, got in outs.items():
        for case, want in final.items():
            if name == "parent":
                err = (got[case].double() - want.double()).abs().max()
                rel = (err / want.double().abs().max()).item()
                ok = rel <= 4e-6   # each within 2e-6 of the float64 plain
                print(f"agree {name} {case}: rel {rel:.3e} "
                      f"{'OK' if ok else 'FAIL'}")
            else:
                ok = torch.equal(got[case], want)
                print(f"agree {name} {case}: "
                      f"{'bit for bit' if ok else 'FAIL: bits differ'}")
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
