#!/usr/bin/env python3
"""Times two redesigned hand-written kernels of the tree it is run in, on
one NVIDIA GPU, and prints one JSON object.  Which two:

* by default the rotamer-BP kernels, K2 (`bp_bethe_pairs_fwd`, ubiquitin)
  and K6 (`bp_bethe_planes_fwd`, RNase A): one wrapper call, warm-started
  from its own solution at the bundle's BP tolerance, at 64 and at 512
  replicas (the 64-replica inputs tiled);
* with `--spline-bwd` the unfused pair-spline kernels and K3: K3
  (`fused_pair_bwd_recompute`, no-env ubiquitin), K4's forward and
  backward (`colsum_fwd`, `colsum_bwd`, both coverage calls of an RNase A
  evaluation in one timed call) and K5's forward and backward
  (`quadspline_fwd`, `quadspline_bwd`, the rotamer grid of RNase A): one
  wrapper call (the backwards under a random cotangent), at
  SPLINE_REPLICAS replicas of perturbed positions (64 to 512, across the
  replica counts where the row-tile kernels change from four warps a row
  tile to one); beside K5's forward `grid_zero`, one `zero_` of a grid of
  its output's shape: the time the card takes to write those bytes
  alone;
* with `--fused` the fused pair block of the main path, K1's forward
  (`fused_pair_fwd` with its residual) and backward (`fused_pair_bwd`
  from that residual, under a random cotangent), and K3 with the env band
  beside them, on full ubiquitin at SPLINE_REPLICAS replicas of perturbed
  positions.  It takes either
  layout of the residual: the dense planes of the trees before the
  compact one, or the compact one.

What it measures is chosen by flags (`--calls` when none is given):

    --calls   for each kernel and replica count `ms`, the CUDA-event
              median of a call on an idle card (host side included), and
              from `torch.profiler` the device time of the call's
              launches (`device_ms`), split by launch (and for K2 and K6
              by pass)
    --tight   (BP) the cold and warm sweep counts and final deviations of
              the kernel and of the plain version at BP tol 1e-6 on four
              replicas, and the deviation after 200 sweeps with the
              convergence test off: the floor float32 rounding leaves it
    --share   (--spline-bwd or --fused, with --calls) each kernel's
              share of the device time of an MD round on its bundle: its
              device ms per timed call times the timed calls an
              evaluation makes (K4's timed call is both coverage calls,
              one an evaluation), over the
              profiled round's device time per evaluation (printed too),
              at 64 and 512 replicas
    --md      MD steps/s at 64 and 512 replicas on both kernels' bundles
              (--fused: ubiquitin only)
    --train   (--spline-bwd) seconds per `fit_packed` step on no-env
              ubiquitin, as chip_smoke.py's training phase runs it

The timing functions are those of this file's own tree (`chip_smoke.py`
beside `tools/`); the operands come from the `chip_smoke` and
`upside_md_torch` of the current directory, through functions every
version of the port since K3 has, so two trees can be compared on one card
within one command, in turns:

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
# K3 gives a row tile one warp from 176 replicas of no-env ubiquitin on
# (24 row tiles a replica, 132 SMs x 32 warps), K4 from 352 (hydrophobe
# coverage, 12 row tiles) and 528 (hbond coverage, 8), K5's backward from
# 249 (17 row tiles)
SPLINE_REPLICAS = (64, 128, 256, 384, 512)
ROUNDS = 5          # rounds of the profiled MD advance (--share)
# timed calls an evaluation makes (K4's timed call runs both coverage
# calls of an evaluation)
CALLS_PER_EVAL = {"fused_pair_bwd_recompute": 1, "colsum_bwd": 1,
                  "colsum_fwd": 1, "quadspline_fwd": 1, "quadspline_bwd": 1,
                  "fused_pair_fwd": 1, "fused_pair_bwd": 1}


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


def time_k3(cs, timing, dev, gen, n):
    """K3 at n replicas of perturbed no-env ubiquitin."""
    import torch
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.ops.fused_pair import (fused_pair_bwd_recompute,
                                                fused_pair_fwd)
    path = os.path.join(DATA_DIR, cs.BUNDLE_NOENV)
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    system, _ = cs.load_system(path, dev, True)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(cs.perturbed(base, n, gen, dev))
        o = cs.fused_operands(system, outs, gen, dev)
        prep, x = o["prep"], o["x"]
        g = [o["randn"](t)
             for t in fused_pair_fwd(prep, *x, want_planes=False)[:3]]
        rec = timing.time_launches(
            "fused_pair_bwd_recompute",
            lambda: fused_pair_bwd_recompute(prep, *x, *g), n)
    return rec


def time_unfused(cs, timing, dev, gen, n):
    """K4's forward and backward (both coverage calls each), K5's forward
    and backward, and the zeroing of a grid of K5's output shape, at n
    replicas of perturbed RNase A."""
    import torch
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import quadspline as qs
    path = os.path.join(DATA_DIR, cs.BUNDLE_UNFUSED)
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    system, _ = cs.load_system(path, dev, True)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(cs.perturbed(base, n, gen, dev))
        covs, (c, p, beads, _) = cs.unfused_operands(system, outs)
        del outs
        calls = [(cps, cps.table(table), x1, x2, w1,
                  torch.randn(x2[..., 0].shape, generator=gen, device=dev))
                 for _, cps, table, x1, x2, w1 in covs]
        ps = c["spline"]
        tab = ps.table(p["interaction_param"])
        g = torch.randn((n, ps.n1, ps.n2), generator=gen, device=dev)
        grid = torch.empty_like(g)
        recs = {"colsum_bwd": timing.time_launches(
                    "colsum_bwd", lambda: [qs.colsum_bwd(*a) for a in calls],
                    n),
                "colsum_fwd": timing.time_launches(
                    "colsum_fwd",
                    lambda: [qs.colsum_fwd(*a[:5]) for a in calls], n),
                "quadspline_bwd": timing.time_launches(
                    "quadspline_bwd",
                    lambda: qs.quadspline_bwd(ps, tab, beads, beads, g), n),
                "quadspline_fwd": timing.time_launches(
                    "quadspline_fwd",
                    lambda: qs.quadspline_fwd(ps, tab, beads, beads), n),
                "grid_zero": timing.time_launches(
                    "grid_zero (K5 fwd's output bytes alone)", grid.zero_,
                    n)}
    del system, calls, g, grid
    torch.cuda.empty_cache()
    return recs


def time_k1(cs, timing, dev, gen, n):
    """K1's forward and backward at n replicas of perturbed ubiquitin, and
    K3 with the env band (the backward of `System(residuals=False)`) on the
    same cotangents.  The forward's residual is whatever the tree's forward returns after
    (cov, E_pair, env): (planes, vcov) before the compact residual, one
    `PackedResiduals` after, and the backward takes it as it comes."""
    import torch
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.ops.fused_pair import (fused_pair_bwd,
                                                fused_pair_bwd_recompute,
                                                fused_pair_fwd)
    path = os.path.join(DATA_DIR, cs.BUNDLE)
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    system, _ = cs.load_system(path, dev, True)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(cs.perturbed(base, n, gen, dev))
        o = cs.fused_operands(system, outs, gen, dev)
        prep, x = o["prep"], o["x"]
        fk = fused_pair_fwd(prep, *x)
        res = fk[3:]
        g = [o["randn"](t) for t in fk[:3]]
        recs = {"fused_pair_fwd": timing.time_launches(
                    "fused_pair_fwd", lambda: fused_pair_fwd(prep, *x), n),
                "fused_pair_bwd": timing.time_launches(
                    "fused_pair_bwd",
                    lambda: fused_pair_bwd(prep, *x, *res, *g), n),
                "fused_pair_bwd_recompute (env band)": timing.time_launches(
                    "fused_pair_bwd_recompute (K3, env band)",
                    lambda: fused_pair_bwd_recompute(prep, *x, *g), n)}
    del system, outs, o, x, fk, res, g
    torch.cuda.empty_cache()
    return recs


def md_device_s_per_eval(cs, dev, bundle_name, n):
    """Device time of one evaluation of an MD round (`torch.profiler` over
    ROUNDS rounds after a 2-round warm-up), and the idle share."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    from upside_md_torch import DATA_DIR
    from upside_md_torch.md.sim import Simulation
    system, pos0 = cs.load_system(os.path.join(DATA_DIR, bundle_name), dev)
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=3)
    state = sim.advance(sim.initial_state(pos0, n, temperature=0.85), 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance(state, ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_s = sum(e.device_time for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) * 1e-6
    del sim, state, system
    torch.cuda.empty_cache()
    return dev_s / (3 * ROUNDS), 1.0 - dev_s / wall


def time_spline_bwd(cs, timing, flags, dev, out):
    """K3 and K4's and K5's forward and backward at SPLINE_REPLICAS
    (`--calls`), and their shares of an MD round's device time
    (`--share`), into `out`."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in SPLINE_REPLICAS:
        out["calls"][f"fused_pair_bwd_recompute@{n}"] = time_k3(
            cs, timing, dev, gen, n)
        for name, rec in time_unfused(cs, timing, dev, gen, n).items():
            out["calls"][f"{name}@{n}"] = rec
    if "--share" not in flags:
        return
    add_shares(cs, dev, out, ("fused_pair_bwd_recompute",), cs.BUNDLE_NOENV)
    add_shares(cs, dev, out, ("colsum_bwd", "colsum_fwd", "quadspline_fwd",
                              "quadspline_bwd"), cs.BUNDLE_UNFUSED)


def time_fused(cs, timing, flags, dev, out):
    """K1's forward and backward at SPLINE_REPLICAS (`--calls`), and their
    shares of a full-ubiquitin MD round's device time (`--share`), into
    `out`."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in SPLINE_REPLICAS:
        for name, rec in time_k1(cs, timing, dev, gen, n).items():
            out["calls"][f"{name}@{n}"] = rec
    if "--share" in flags:
        add_shares(cs, dev, out, ("fused_pair_fwd", "fused_pair_bwd"),
                   cs.BUNDLE)


def add_shares(cs, dev, out, names, bundle_name):
    """The shares of `names` (timed in out["calls"]) of the device time of
    an MD round on `bundle_name`, at REPLICAS, into out["share"]."""
    out.setdefault("share", {})
    for n in REPLICAS:
        per_eval, idle = md_device_s_per_eval(cs, dev, bundle_name, n)
        for name in names:
            call = out["calls"][f"{name}@{n}"]["device_ms"]
            share = None if call is None else \
                call * 1e-3 * CALLS_PER_EVAL[name] / per_eval
            out["share"][f"{name}@{n}"] = {
                "device_s_per_eval": per_eval, "idle_share": idle,
                "share_of_device": share}
            print(f"[share] {name} at {n} replicas: device time per "
                  f"evaluation {per_eval * 1e3:.4f} ms (idle share "
                  f"{idle:.3f}), the kernel's share {share}", flush=True)


def main():
    import torch
    import chip_smoke as cs
    from upside_md_torch import DATA_DIR
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    spline = "--spline-bwd" in sys.argv[1:]
    fused = "--fused" in sys.argv[1:]
    flags = [f for f in sys.argv[1:] if f not in ("--spline-bwd", "--fused")
             ] or ["--calls"]
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "card": cs.card_line(), "calls": {}}
    if fused and "--calls" in flags:
        time_fused(cs, own_smoke(), flags, dev, out)
    elif spline and "--calls" in flags:
        time_spline_bwd(cs, own_smoke(), flags, dev, out)
    elif not spline and not fused and ("--calls" in flags
                                       or "--tight" in flags):
        time_kernels(cs, own_smoke(), flags, dev, out)
    if "--md" in flags:
        out["md_steps_per_s"] = {}
        paths = [("no-env ubiquitin", cs.BUNDLE_NOENV, cs.NOENV_KERNELS)
                 if spline else ("ubiquitin", cs.BUNDLE, cs.FUSED_KERNELS)]
        if not fused:
            paths.append(("RNase A", cs.BUNDLE_UNFUSED, cs.UNFUSED_KERNELS))
        for label, name, names in paths:
            md, _ = cs.run_md(os.path.join(DATA_DIR, name), dev, label, names)
            out["md_steps_per_s"][label] = {
                n: {"steps_per_s": r["steps_per_s"], "times_s": r["times_s"]}
                for n, r in md.items()}
    if spline and "--train" in flags:
        from upside_md_torch.config import bundle
        path = os.path.join(DATA_DIR, cs.BUNDLE_NOENV)
        base = torch.as_tensor(bundle.load(path)[1], device=dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        train, _ = cs.run_train(path, dev, gen, base)
        out["train"] = {k: train[k] for k in ("loss", "s_per_step",
                                              "step_s")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
