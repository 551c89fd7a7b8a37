"""Where the time of the port's MD round, or of a training step, goes, on
one NVIDIA GPU.

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
                                      [--rounds 5] [--train N] [--out DIR]

NAME is a bundle in upside_md_torch/data, without `.npz`.  With `--train
N` it profiles `--rounds` steps of `training.fit_packed` of the rotamer
table under the energy-gap loss on N configurations (perturbed from the
bundle's structure by a seeded 0.1 normal), after one warm-up step,
instead of MD, and also prints the host operators that took the most
host time.
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
    ap.add_argument("--train", type=int, default=0)
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

    def profiled(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
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
        rec = {"wall_s": wall, "device_s": dev_us * 1e-6,
               "idle_share": 1.0 - dev_us * 1e-6 / wall,
               "kernel_launches": len(kern),
               "top": [{"name": n[:90], "calls": c, "ms": t * 1e-3,
                        "share_of_device": t / max(dev_us, 1e-9)}
                       for n, (c, t) in top]}
        return rec, prof

    def show(rec):
        for t in rec["top"]:
            print(f"    {t['ms']:9.3f} ms {t['share_of_device']:6.1%} "
                  f"x{t['calls']:<5d} {t['name']}", flush=True)

    if args.train:
        from upside_md_torch import training
        gen = torch.Generator(device=dev).manual_seed(5)
        pos = pos0[None] + 0.1 * torch.randn((args.train,) + pos0.shape,
                                             generator=gen, device=dev)
        states = training.rotamer_node_marginals(system, pos[0]).argmax(-1)
        fixed = training.rotamer_state_restricted_system(system,
                                                         states.cpu())

        def fit(n):
            training.fit_packed(
                system, lambda p: training.energy_gap_loss(
                    fixed, system, pos)(p, {}), system.params, ["rotamer"],
                n_steps=n, learning_rate=0.03)

        fit(1)
        rec, prof = profiled(lambda: fit(args.rounds))
        rec["s_per_step"] = rec["wall_s"] / args.rounds
        rec["launches_per_step"] = rec["kernel_launches"] / args.rounds
        host = sorted(prof.key_averages(),
                      key=lambda a: -a.self_cpu_time_total)[:args.top]
        rec["host_top"] = [{"name": a.key[:90], "calls": a.count,
                            "self_cpu_ms": a.self_cpu_time_total * 1e-3}
                           for a in host]
        report["train"] = rec
        print(f"[{args.bundle}, training, {args.train} configurations] "
              f"{rec['s_per_step']:.4f} s per step, device busy "
              f"{rec['device_s'] / args.rounds:.4f} s per step, idle share "
              f"{rec['idle_share']:.3f}, {rec['launches_per_step']:.0f} "
              f"kernel launches per step", flush=True)
        show(rec)
        print("  host operators by self host time:", flush=True)
        for a in rec["host_top"]:
            print(f"    {a['self_cpu_ms']:9.3f} ms x{a['calls']:<6d} "
                  f"{a['name']}", flush=True)
    for n_rep in ([] if args.train else args.replicas):
        sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=3)
        state = sim.initial_state(pos0, n_rep, temperature=0.85)
        state = sim.advance(state, 2)
        box = {"state": state}
        rec, _ = profiled(lambda: box.update(
            state=sim.advance(box["state"], args.rounds)))
        evals = 3 * args.rounds
        rec["launches_per_eval"] = rec["kernel_launches"] / evals
        rec["steps_per_s"] = evals * n_rep / rec["wall_s"]
        report[n_rep] = rec
        print(f"[{args.bundle}, {n_rep} replicas] wall {rec['wall_s']:.4f} s"
              f" for {args.rounds} rounds, device busy "
              f"{rec['device_s']:.4f} s, idle share "
              f"{rec['idle_share']:.3f}, {rec['kernel_launches']} kernel "
              f"launches ({rec['launches_per_eval']:.0f}/eval), "
              f"{rec['steps_per_s']:.1f} steps/s under the profiler",
              flush=True)
        show(rec)
        del sim, box
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_torch_md.json"), "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
