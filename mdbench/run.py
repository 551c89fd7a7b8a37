"""Runs one cell of the benchmark of `upside_md_torch` on one NVIDIA GPU.

    python3 mdbench/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a file `mdbench/workloads/CELL.json`.  The run builds the cell's
system, warms up every shape it uses (set-up), measures for S seconds,
then checks what the window produced against the plain reference in
`mdbench/reference/`.  With --trace 0 it reports the cell's end-to-end
metrics, with --trace 1 its per-layer metrics from a `torch.profiler`
window.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` when traced),
then `checks`, each number compared beside its limit, which are also the
last lines of standard error.

It exits non-zero and prints no result without enough CUDA devices, or if
JAX or the JAX package was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "mdbench", "_cache", _dir)
sys.path.insert(0, ROOT)


def main(argv=None, device=None, workload=None):
    """Run a cell; returns the exit code.  `device` and `workload` (a
    workload dict) are for tests on the CPU: from the command line the run
    takes the first CUDA device and the workload file."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from mdbench import harness
    wl = workload or harness.load_workload(args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"{wl['name']} needs {wl['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = harness.load_module("modes", wl["mode"]).Run(wl, device, args.seed)
    result = run.execute(args.seconds, bool(args.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that must not be loaded were loaded: {bad}",
              file=sys.stderr)
        return 3
    harness.report({k: result[k] for k in (
        "correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks") if k in result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
