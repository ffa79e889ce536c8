"""Launch a function on every rank of a new process group, one process a
rank, from one parent process: the tests' and the dry run's counterpart
of torchrun.

    run_ranks("pkg.module:fn", world=4, workdir=d)        # in the parent
    python -m xcontour_tpu_torch.parallel.launch TARGET WORKDIR BACKEND ...

Each rank process sets RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE,
uses one CPU thread, joins the group through a file in ``workdir`` (no
port is taken, so launches can run side by side), calls
``fn(workdir, *args)`` and leaves the group.  ``TARGET`` is
``module:function`` or ``path/to/file.py:function`` (loaded by path, so a
helper file beside the tests imports nothing else of them).  A rank that
fails, or a launch that outlives its timeout, fails the launch and the
remaining ranks are killed: no rank is left waiting in a collective.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import subprocess
import sys
import time
import uuid
from typing import Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "xcontour_tpu_torch.parallel.launch"


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_ranks(target: str, world: int, workdir: str, *,
              backend: str = "gloo", args: Sequence[str] = (),
              timeout: float = 300.0, env: dict = None) -> list:
    """Run ``target`` on ``world`` ranks; returns each rank's log text.
    Raises RuntimeError naming the first rank that failed (with its log)
    or TimeoutError after ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"pg_{uuid.uuid4().hex}")
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(base, RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
            log = os.path.join(workdir, f"rank{r}.log")
            logs.append(log)
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", _MODULE, target, workdir,
                     backend, store, str(timeout), *map(str, args)],
                    env=e, stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{codes[r]}:\n{_tail(logs[r])}")
            if all(c == 0 for c in codes):
                return [_tail(log, 1 << 20) for log in logs]
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{target} on {world} ranks did not finish within "
                    f"{timeout:g} s:\n" + "\n".join(
                        f"rank {r}: {_tail(log, 800)}"
                        for r, log in enumerate(logs)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if os.path.exists(store):
            os.remove(store)


def resolve(target: str):
    """The function a ``module:function`` or ``file.py:function`` names."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_rank_" + os.path.splitext(os.path.basename(where))[0], where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def _main(argv) -> int:
    target, workdir, backend, store, timeout, *args = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{store}",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        resolve(target)(workdir, *args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
