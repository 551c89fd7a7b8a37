#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`upside_md_torch`) on one NVIDIA GPU.

Drives the port's main path, the full-force-field MD of 76-residue
ubiquitin (synthetic parameter libraries, random initial structure from the
bundle's seed) as a replica ensemble, through the hand-written Hopper
kernels, and checks it:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles upside_md_torch/csrc/*.cu with nvcc for sm_90a;
3. kernel vs plain PyTorch at the main path's shapes (4 replicas,
   perturbed positions): K1 forward outputs (rel 1e-5), K1 backward under
   a random cotangent (rel 1e-4), K2 at BP tol 1e-6 (F, G1, dE rel 1e-4),
   and the whole evaluation's energy and forces (rel < 1e-3);
4. times each kernel and its plain version with CUDA events (median);
5. MD: `Simulation.advance` at 64 and 512 replicas after a warm-up;
   positions must stay finite; prints steps/s, mean BP sweeps and the
   kernels' launch counts, which must all be > 0;
6. prints the kernel table as one JSON line, the card's name and power
   limit, and last `{"ok": true, "device": {...}}`.

Every failed check raises and the script exits non-zero.  Run from the
repository root:

    python3 chip_smoke.py [--out DIR]

--out writes the full results as JSON into DIR.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = "ubiquitin_full_synth.npz"
KERNEL_INFO = {
    "fused_pair_fwd": ("upside_md_torch/csrc/fused_pair_fwd.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:1021"),
    "fused_pair_bwd": ("upside_md_torch/csrc/fused_pair_bwd.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:1276"),
    "bp_bethe_pairs": ("upside_md_torch/csrc/bp_bethe_pairs.cu",
                       "upside_md_tpu/ops/pallas_bp.py:965"),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def rel_err(a, b):
    """max |a - b| / max |b| (and the max abs error)."""
    d = (a.double() - b.double()).abs().max().item()
    return d / max(b.double().abs().max().item(), 1e-30), d


def cuda_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def check(name, err, tol):
    log(f"  {name}: rel err {err:.3e} (tol {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: rel err {err} >= {tol}")


def main():
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, ROOT)
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.nodes.rotamer import assemble_one_body
    from upside_md_torch.ops import kernels
    from upside_md_torch.ops.bp_pairs import bp_bethe_pairs_fwd
    from upside_md_torch.ops.fused_pair import fused_pair_bwd, fused_pair_fwd
    from upside_md_torch.system import System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {"phases": {}}

    # ---- 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    results["card"] = card

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain at main-path shapes
    specs, pos0 = bundle.load(os.path.join(DATA_DIR, BUNDLE))
    for s in specs:
        if s.type_name == "rotamer":
            s.consts["tol"] = 1e-6
    sys_k = System(len(pos0), specs, dev, torch.float32, kernels=True)
    sys_p = System(len(pos0), specs, dev, torch.float32, kernels=False)
    gen = torch.Generator(device=dev).manual_seed(7)
    base = torch.as_tensor(pos0, device=dev)
    pos = base[None] + 0.1 * torch.randn((4,) + base.shape, generator=gen,
                                         device=dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    plan = sys_k.pair_fusion
    prep = sys_k.fused_prepared()
    x1, w1, x2, wcol = plan.block_inputs(sys_k.consts, outs)
    log(f"[compare] rows {prep.n1} (hbond {prep.r_b}, hydrophobe "
        f"{prep.r_e - prep.r_b}, env {prep.n_e}, beads {prep.n2}) x "
        f"{prep.n2} columns, 4 replicas")
    errs = {}
    fk = fused_pair_fwd(prep, x1, w1, x2, wcol)
    fp = fused_pair_fwd(prep, x1, w1, x2, wcol, plain=True)
    torch.cuda.synchronize()
    e_fwd = 0.0
    for nm, a, b in zip(("cov", "E_pair", "env", "planes", "vcov"), fk, fp):
        e, d = rel_err(a, b)
        check(f"K1 fwd {nm}", e, 1e-5)
        e_fwd = max(e_fwd, d)
    errs["fused_pair_fwd"] = e_fwd
    g_cov = torch.randn(fp[0].shape, generator=gen, device=dev)
    g_grid = torch.randn(fp[1].shape, generator=gen, device=dev)
    g_env = torch.randn(fp[2].shape, generator=gen, device=dev)
    bk = fused_pair_bwd(prep, x1, w1, x2, wcol, fk[3], fk[4], g_cov, g_grid,
                        g_env)
    bp = fused_pair_bwd(prep, x1, w1, x2, wcol, fp[3], fp[4], g_cov, g_grid,
                        g_env, plain=True)
    torch.cuda.synchronize()
    e_bwd = 0.0
    for nm, a, b in zip(("d1", "d2"), bk, bp):
        e, d = rel_err(a, b)
        check(f"K1 bwd {nm}", e, 1e-4)
        e_bwd = max(e_bwd, d)
    errs["fused_pair_bwd"] = e_bwd

    rot = plan.rot
    st = sys_k.consts[rot.name]["bp"]
    E1 = assemble_one_body(sys_k.consts[rot.name],
                           [outs[a] for a in rot.args])
    E_pair = fp[1]
    kk = bp_bethe_pairs_fwd(st, E1, E_pair)
    pp = bp_bethe_pairs_fwd(st, E1, E_pair, plain=True)
    again = bp_bethe_pairs_fwd(st, E1, E_pair)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kk, again)):
        raise AssertionError("K2 is not deterministic on identical inputs")
    log(f"  K2 sweeps kernel {kk[6].tolist()} plain {pp[6].tolist()}, "
        f"final dev kernel {kk[5].max().item():.2e}")
    e_bp = 0.0
    for nm, i in (("F", 0), ("G1", 1), ("dE", 2)):
        e, d = rel_err(kk[i], pp[i])
        check(f"K2 {nm}", e, 1e-4)
        e_bp = max(e_bp, d)
    e, _ = rel_err(kk[3], pp[3])
    check("K2 beliefs", e, 1e-4)
    warm = (kk[3], kk[4])
    kw = bp_bethe_pairs_fwd(st, E1, E_pair, warm)
    pw = bp_bethe_pairs_fwd(st, E1, E_pair, warm, plain=True)
    for nm, i in (("F warm", 0), ("G1 warm", 1), ("dE warm", 2)):
        e, d = rel_err(kw[i], pw[i])
        check(f"K2 {nm}", e, 1e-4)
        e_bp = max(e_bp, d)
    errs["bp_bethe_pairs"] = e_bp

    gk, ek, _ = sys_k.deriv(pos, sys_k.init_cache(4))
    gp, ep, _ = sys_p.deriv(pos, sys_p.init_cache(4))
    err_e = ((ek - ep).abs() / ep.abs().clamp(min=1.0)).max().item()
    err_g = ((gk - gp).pow(2).mean().sqrt()
             / gp.pow(2).mean().sqrt().clamp(min=1e-12)).item()
    check("whole evaluation energy", err_e, 1e-3)
    check("whole evaluation force RMS", err_g, 1e-3)
    if not (torch.isfinite(gk).all() and torch.isfinite(ek).all()):
        raise AssertionError("non-finite energy or forces")
    results["phases"]["compare"] = {
        "max_abs_err": errs, "energy_rel": err_e, "force_rms_rel": err_g}

    del sys_k, sys_p, fk, fp, bk, bp, kk, pp, kw, pw

    # ---- 4. timing, kernel vs plain, at the 64-replica point of the main
    # path with the config's BP tolerance and a warm start, as in MD
    specs, pos0 = bundle.load(os.path.join(DATA_DIR, BUNDLE))
    system = System(len(pos0), specs, dev, torch.float32)
    sys_p = System(len(pos0), specs, dev, torch.float32, kernels=False)
    n_t = 64
    pos = base[None] + 0.1 * torch.randn((n_t,) + base.shape, generator=gen,
                                         device=dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    prep = system.fused_prepared()
    x1, w1, x2, wcol = plan.block_inputs(system.consts, outs)
    fk = fused_pair_fwd(prep, x1, w1, x2, wcol)
    g_cov = torch.randn(fk[0].shape, generator=gen, device=dev)
    g_grid = torch.randn(fk[1].shape, generator=gen, device=dev)
    g_env = torch.randn(fk[2].shape, generator=gen, device=dev)
    st = system.consts[rot.name]["bp"]
    E1 = assemble_one_body(system.consts[rot.name],
                           [outs[a] for a in rot.args])
    cold = bp_bethe_pairs_fwd(st, E1, fk[1])
    warm = (cold[3], cold[4])
    ms = {
        "fused_pair_fwd": (
            cuda_ms(lambda: fused_pair_fwd(prep, x1, w1, x2, wcol)),
            cuda_ms(lambda: fused_pair_fwd(prep, x1, w1, x2, wcol,
                                           plain=True), reps=5)),
        "fused_pair_bwd": (
            cuda_ms(lambda: fused_pair_bwd(prep, x1, w1, x2, wcol, fk[3],
                                           fk[4], g_cov, g_grid, g_env)),
            cuda_ms(lambda: fused_pair_bwd(prep, x1, w1, x2, wcol, fk[3],
                                           fk[4], g_cov, g_grid, g_env,
                                           plain=True), reps=5)),
        "bp_bethe_pairs": (
            cuda_ms(lambda: bp_bethe_pairs_fwd(st, E1, fk[1], warm)),
            cuda_ms(lambda: bp_bethe_pairs_fwd(st, E1, fk[1], warm,
                                               plain=True), reps=5)),
    }
    for nm, (a, b) in ms.items():
        log(f"[time] {nm}: kernel {a:.4f} ms, plain {b:.4f} ms "
            f"({n_t} replicas)")
    results["phases"]["time_ms"] = ms
    del sys_p, outs, fk
    torch.cuda.empty_cache()

    # ---- 5. MD through the main path
    md = {}
    kernels.reset_counts()
    for n_rep in (64, 512):
        sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=1)
        state = sim.initial_state(pos0, n_rep, temperature=0.85)
        state = sim.advance(state, 2)                      # warm-up
        torch.cuda.synchronize()
        rounds, times = 5, []
        for _ in range(3):
            s0, e0 = state.bp_sweeps.sum().item(), state.n_evals
            t0 = time.perf_counter()
            state = sim.advance(state, rounds)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sweeps = (state.bp_sweeps.sum().item() - s0) / (
            (state.n_evals - e0) * n_rep)
        if not (state.pos.shape == (n_rep,) + tuple(pos0.shape)
                and torch.isfinite(state.pos).all()):
            raise AssertionError(f"MD at {n_rep} replicas: bad positions")
        rate = 3 * rounds * n_rep / statistics.median(times)
        md[n_rep] = {"steps_per_s": rate, "times_s": times,
                     "mean_bp_sweeps": sweeps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[md] {n_rep} replicas: {rate:.1f} steps/s (median of "
            f"{[round(t, 4) for t in times]} s per {rounds} rounds), mean "
            f"BP sweeps {sweeps:.2f}, positions finite")
        del sim, state
        torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    log(f"[md] kernel launches on the main path: {launches}")
    for nm, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {nm} was not launched by MD")
    results["phases"]["md"] = md

    # ---- 6. report
    table = {"kernels": [
        {"name": nm, "route": "cuda", "source": KERNEL_INFO[nm][0],
         "replaces": KERNEL_INFO[nm][1], "launches": launches[nm],
         "max_abs_err": errs[nm], "ms": ms[nm][0], "plain_ms": ms[nm][1]}
        for nm in kernels.KERNELS]}
    results.update(table)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(table), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
