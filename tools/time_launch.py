#!/usr/bin/env python3
"""Host cost of the port's kernel launches, for the tree in the current
directory.

    python3 tools/time_launch.py [--calls 2000] [--repeats 5]

Run from a tree's root it imports that tree's `upside_md_torch`, so one
command can time two trees on one card (`cd OLD && python3
NEW/tools/time_launch.py`).  On ubiquitin_full_synth at one replica it
enqueues `--calls` wrapper calls of K1's forward (`fused_pair_fwd`) and
of K2 (`bp_bethe_pairs`, warm) back to back and reads the host clock
after the last is enqueued and again after a synchronize: microseconds a
call to enqueue (the wrapper's host side and `ops.kernels.launch`) and to
finish, the median of `--repeats`.  It also times the device guard that
`ops.kernels.launch` runs before each launch (the operands' device
indices, `torch.cuda.device`, that device's current stream) beside the
stream lookup it replaced, on each wrapper's own operands: `guard_us` and
`stream_us` a launch.  Prints one JSON line with the card's name and
power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from upside_md_torch import DATA_DIR
    from upside_md_torch.nodes.rotamer import assemble_one_body
    from upside_md_torch.ops import kernels
    from upside_md_torch.ops.bp_pairs import bp_bethe_pairs_fwd
    from upside_md_torch.ops.fused_pair import fused_pair_fwd
    from upside_md_torch.system import System
    kernels.library()
    dev = torch.device("cuda", 0)
    system, pos = System.from_bundle(
        os.path.join(DATA_DIR, "ubiquitin_full_synth.npz"), device=dev)
    x = pos[None]
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(x)
    plan = system.pair_fusion
    prep = system.fused_prepared()
    ops = plan.block_inputs(system.consts, outs)
    rot = plan.rot
    st = system.consts[rot.name]["bp"]
    E1 = assemble_one_body(system.consts[rot.name],
                           [outs[a] for a in rot.args])
    E_pair = fused_pair_fwd(prep, *ops)[1]
    cold = bp_bethe_pairs_fwd(st, E1, E_pair)
    warm = (cold[3], cold[4])
    calls = {"fused_pair_fwd": lambda: fused_pair_fwd(prep, *ops),
             "bp_bethe_pairs": lambda: bp_bethe_pairs_fwd(st, E1, E_pair,
                                                          warm)}
    # each wrapper's operands, as it hands them to kernels.launch
    operands, launch = {}, kernels.launch

    def spy(name, *args):
        operands[name] = args
        return launch(name, *args)
    kernels.launch = spy
    for fn in calls.values():
        fn()
    kernels.launch = launch

    def guard(args):
        devices = {a.get_device() for a in args
                   if isinstance(a, torch.Tensor)}
        (index,) = devices
        with torch.cuda.device(index):
            return torch.cuda.current_stream(index).cuda_stream

    def stream(args):
        return torch.cuda.current_stream().cuda_stream

    out = {}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        enq, done = [], []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enq.append((t1 - t0) / args.calls * 1e6)
            done.append((t2 - t0) / args.calls * 1e6)
        out[name] = {"enqueue_us": statistics.median(enq),
                     "finish_us": statistics.median(done),
                     "enqueue_us_all": enq}
        for key, part in (("guard_us", guard), ("stream_us", stream)):
            reps = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    part(operands[name])
                reps.append((time.perf_counter() - t0) / args.calls * 1e6)
            out[name][key] = statistics.median(reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": os.getcwd(), "card": card, "calls": args.calls,
                      "launch": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
