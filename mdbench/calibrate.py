"""Readings for setting a cell's limits, on the chip at the cell's own
size: the program's numbers over many seeds, the control's (the reference
computed in bfloat16 in the program's place) and, for a training cell, the
planted faults'.  The benchmark's own runs never run this.

    python3 mdbench/calibrate.py --workload CELL --seconds S
        --seeds N [N ...] [--control K] [--faults K]

The control (and the faults) run on the first K seeds.  One JSON line a
seed: {"seed", "program": {number: value}, "control": {...}, "faults":
{fault: {...}}}, then one line with the largest program reading and the
smallest control and fault readings of each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def train_faults(run, seconds):
    """Readings of the planted faults of a training cell, each against the
    reference on the cell's true inputs: the loss over half the ensemble
    (the mean over the rest), and the loss (so every gradient) scaled by
    1.01.  A step that leaves the tables unchanged reads 1 on change_gap
    by the measure itself and needs no run."""
    loss, temperature = run.loss, run.wl["temperature"]

    def half_batch(training, system, pos0, ens):
        return training.contrastive_divergence_loss(
            system, pos0, ens[:len(ens) // 2], temperature)

    def scaled_loss(*args):
        inner = loss(*args)
        return lambda trainable, frozen: 1.01 * inner(trainable, frozen)

    planted = {"half_batch": half_batch, "scaled_loss": scaled_loss}
    out = {}
    for name, fault in planted.items():
        run.loss = fault
        res = run.execute(seconds, False, time.perf_counter())
        out[name] = {k: c["value"] for k, c in res["checks"].items()}
    run.loss = loss
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args()
    import torch
    from mdbench import harness
    wl = harness.load_workload(args.workload)
    mode = harness.load_module("modes", wl["mode"])
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(args.seeds):
        run = mode.Run(wl, device, seed)
        t = time.perf_counter()
        res = run.execute(args.seconds, False, t)
        row = {"seed": seed, "run_s": time.perf_counter() - t,
               "metrics": {k: m["value"] for k, m in res["metrics"].items()},
               "program": {k: c["value"] for k, c in res["checks"].items()}}
        if i < args.control:
            t = time.perf_counter()
            row["control"] = run.control()
            row["control_s"] = time.perf_counter() - t
        if i < args.faults and wl["mode"] == "train":
            row["faults"] = train_faults(run, args.seconds)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run
        torch.cuda.empty_cache()
    summary = {"largest_program": {k: max(r["program"][k] for r in rows)
                                   for k in rows[0]["program"]}}
    ctl = [r["control"] for r in rows if "control" in r]
    if ctl:
        summary["smallest_control"] = {k: min(c[k] for c in ctl)
                                       for k in ctl[0]}
    flt = [r["faults"] for r in rows if "faults" in r]
    if flt:
        summary["smallest_faults"] = {
            f: {k: min(x[f][k] for x in flt) for k in flt[0][f]}
            for f in flt[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
