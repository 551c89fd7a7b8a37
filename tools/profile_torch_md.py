"""Where the time of the port's MD round goes, on one NVIDIA GPU.

Runs `upside_md_torch.md.sim.Simulation.advance` on a bundle (ubiquitin by
default; `--bundle rnase_a_full_synth` takes the unfused path of more than
512 beads) at each requested replica count, once to warm up and once under
`torch.profiler`, and prints per run: the wall time of the profiled
advance, the summed device time of all kernels, the device idle share
(1 - device time / wall time), the number of kernel launches, and the
device time of the heaviest kernels by name.  Device times come from the
profiler's CUDA activity records; nothing here is timed on the host except
the wall clock around a synchronised advance.

    python3 tools/profile_torch_md.py [--bundle NAME] [--replicas 64 512]
                                      [--rounds 5] [--out DIR]

NAME is a bundle in upside_md_torch/data, without `.npz`.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bundle", default="ubiquitin_full_synth")
    ap.add_argument("--replicas", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    sys.path.insert(0, ROOT)
    from upside_md_torch import DATA_DIR
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.system import System

    dev = torch.device("cuda", 0)
    system, pos0 = System.from_bundle(
        os.path.join(DATA_DIR, args.bundle + ".npz"), dev)
    report = {"bundle": args.bundle}
    for n_rep in args.replicas:
        sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=3)
        state = sim.initial_state(pos0, n_rep, temperature=0.85)
        state = sim.advance(state, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = sim.advance(state, args.rounds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.device_time for e in kern)
        by_name = {}
        for e in kern:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.device_time)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
        evals = 3 * args.rounds
        rec = {"wall_s": wall, "device_s": dev_us * 1e-6,
               "idle_share": 1.0 - dev_us * 1e-6 / wall,
               "kernel_launches": len(kern),
               "launches_per_eval": len(kern) / evals,
               "steps_per_s": evals * n_rep / wall,
               "top": [{"name": n[:90], "calls": c, "ms": t * 1e-3,
                        "share_of_device": t / max(dev_us, 1e-9)}
                       for n, (c, t) in top]}
        report[n_rep] = rec
        print(f"[{args.bundle}, {n_rep} replicas] wall {wall:.4f} s for "
              f"{args.rounds} rounds, device busy {rec['device_s']:.4f} s, "
              f"idle share {rec['idle_share']:.3f}, {len(kern)} kernel "
              f"launches ({rec['launches_per_eval']:.0f}/eval), "
              f"{rec['steps_per_s']:.1f} steps/s under the profiler",
              flush=True)
        for t in rec["top"]:
            print(f"    {t['ms']:9.3f} ms {t['share_of_device']:6.1%} "
                  f"x{t['calls']:<5d} {t['name']}", flush=True)
        del sim, state
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_torch_md.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
