#!/usr/bin/env python3
"""Times the two rotamer-BP kernels of the tree it is run in, K2
(`bp_bethe_pairs_fwd`, ubiquitin) and K6 (`bp_bethe_planes_fwd`, RNase A),
on one NVIDIA GPU: one wrapper call, warm-started from its own solution at
the bundle's BP tolerance, at 64 and at 512 replicas (the 64-replica
inputs tiled).  Prints one JSON object.  What it measures is chosen by
flags (`--calls` when none is given):

    --calls   for each kernel and replica count `ms`, the CUDA-event
              median of a call on an idle card (host side included), and
              from `torch.profiler` the device time of the call's
              launches (`device_ms`), split by pass and by launch
    --tight   the cold and warm sweep counts and final deviations of the
              kernel and of the plain version at BP tol 1e-6 on four
              replicas, and the deviation after 200 sweeps with the
              convergence test off: the floor float32 rounding leaves it
    --md      MD steps/s at 64 and 512 replicas on both bundles

The timing functions are those of this file's own tree (`chip_smoke.py`
beside `tools/`); the operands come from the `chip_smoke` and
`upside_md_torch` of the current directory, through functions every
version of the port has, so two trees can be compared on one card within
one command:

    (cd OLD_TREE && python3 NEW_TREE/tools/time_torch_bp.py) ; \\
    python3 tools/time_torch_bp.py ; python3 tools/time_torch_bp.py ; \\
    (cd OLD_TREE && python3 NEW_TREE/tools/time_torch_bp.py)
"""

import dataclasses
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.getcwd())

REPLICAS = (64, 512)
TIGHT_TOL, TIGHT_REPLICAS, FLOOR_SWEEPS = 1e-6, 4, 200


def own_smoke():
    """`chip_smoke` of this file's tree, whatever the current directory."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tight(st, fwd):
    """Sweep counts and final deviations at TIGHT_TOL, cold and warm (from
    the cold solution, E1 scaled by 0.98), and the deviation floor, of the
    kernel and the plain version: `fwd(st, scale, init, plain)`."""
    out = {}
    for name, plain in (("kernel", False), ("plain", True)):
        s_ = dataclasses.replace(st, tol=TIGHT_TOL)
        cold = fwd(s_, 1.0, None, plain)
        warm = fwd(s_, 0.98, (cold[3], cold[4]), plain)
        fixed = fwd(dataclasses.replace(st, tol=-1.0, max_iter=FLOOR_SWEEPS),
                    1.0, None, plain)
        out[name] = {"cold_sweeps": cold[6].tolist(),
                     "cold_dev": cold[5].tolist(),
                     "warm_sweeps": warm[6].tolist(),
                     "warm_dev": warm[5].tolist(),
                     "floor_dev": fixed[5].tolist()}
    return out


def time_kernels(cs, timing, flags, dev, out):
    """K2 on ubiquitin, then K6 on RNase A: the operands of one evaluation
    at 64 replicas, the timed calls (`--calls`) and the tight-tolerance
    readings (`--tight`) into `out`."""
    import torch
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import quadspline as qs
    from upside_md_torch.ops.bp_pairs import bp_bethe_pairs_fwd
    from upside_md_torch.ops.bp_planes import bp_bethe_planes_fwd
    from upside_md_torch.ops.fused_pair import fused_pair_fwd
    gen = torch.Generator(device=dev).manual_seed(7)

    def add(name, fwd, n, sweeps):
        rec = timing.time_bp_passes(name, fwd, n)
        rec["sweeps"] = sweeps
        out["calls"][f"{name}@{n}"] = rec

    path = os.path.join(DATA_DIR, cs.BUNDLE)
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    system, _ = cs.load_system(path, dev, True)
    sys_p, _ = cs.load_system(path, dev, False)
    pos = cs.perturbed(base, REPLICAS[0], gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    o = cs.fused_operands(system, outs, gen, dev)
    st, E1 = o["st"], o["E1"]
    E_pair = fused_pair_fwd(o["prep"], *o["x"])[1]
    cold = bp_bethe_pairs_fwd(st, E1, E_pair)
    for n in REPLICAS if "--calls" in flags else ():
        k = n // REPLICAS[0]
        e1, ep = timing.tiled(E1, k), timing.tiled(E_pair, k)
        w = (timing.tiled(cold[3], k), timing.tiled(cold[4], k))
        res = bp_bethe_pairs_fwd(st, e1, ep, w)
        add("bp_bethe_pairs", lambda: bp_bethe_pairs_fwd(st, e1, ep, w), n,
            int(res[6].max()))
    if "--tight" in flags:
        t = slice(0, TIGHT_REPLICAS)
        out["bp_bethe_pairs tight"] = tight(
            st, lambda s_, c, init, plain: bp_bethe_pairs_fwd(
                s_, c * E1[t], E_pair[t], init, plain=plain))
    del system, sys_p, outs, o
    torch.cuda.empty_cache()

    path = os.path.join(DATA_DIR, cs.BUNDLE_UNFUSED)
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    system, _ = cs.load_system(path, dev, True)
    sys_p, _ = cs.load_system(path, dev, False)
    pos = cs.perturbed(base, REPLICAS[0], gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    _, rot_ops = cs.unfused_operands(system, outs)
    c, p, beads, E1 = rot_ops
    grid = qs.quadspline_fwd(c["spline"],
                             c["spline"].table(p["interaction_param"]),
                             beads, beads)
    st, P, adj = cs.bp_planes_inputs(rot_ops, grid)
    cold = bp_bethe_planes_fwd(st, E1, P, adj)
    for n in REPLICAS if "--calls" in flags else ():
        k = n // REPLICAS[0]
        e1, pl, ad = (timing.tiled(a, k) for a in (E1, P, adj))
        w = (timing.tiled(cold[3], k), timing.tiled(cold[4], k))
        res = bp_bethe_planes_fwd(st, e1, pl, ad, w)
        add("bp_bethe_planes",
            lambda: bp_bethe_planes_fwd(st, e1, pl, ad, w), n,
            int(res[6].max()))
    if "--tight" in flags:
        t = slice(0, TIGHT_REPLICAS)
        out["bp_bethe_planes tight"] = tight(
            st, lambda s_, c, init, plain: bp_bethe_planes_fwd(
                s_, c * E1[t], P[t], adj[t], init, plain=plain))
    del system, sys_p, outs, grid, P
    torch.cuda.empty_cache()


def main():
    import torch
    import chip_smoke as cs
    from upside_md_torch import DATA_DIR
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    flags = sys.argv[1:] or ["--calls"]
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "card": cs.card_line(), "calls": {}}
    if "--calls" in flags or "--tight" in flags:
        time_kernels(cs, own_smoke(), flags, dev, out)
    if "--md" in flags:
        out["md_steps_per_s"] = {}
        for label, name, names in (
                ("ubiquitin", cs.BUNDLE, cs.FUSED_KERNELS),
                ("RNase A", cs.BUNDLE_UNFUSED, cs.UNFUSED_KERNELS)):
            md, _ = cs.run_md(os.path.join(DATA_DIR, name), dev, label, names)
            out["md_steps_per_s"][label] = {
                n: {"steps_per_s": r["steps_per_s"], "times_s": r["times_s"]}
                for n, r in md.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
