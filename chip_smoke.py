#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`upside_md_torch`) on one NVIDIA GPU.

Drives the port's paths through the hand-written Hopper kernels, and
checks them:

* the fused path: full-force-field MD of 76-residue ubiquitin (374 beads;
  kernels K1 fwd, K1 bwd from K1 fwd's compact residual, K2);
* the unfused path of more than 512 beads: 124-residue RNase A (543 beads;
  K4 fwd/bwd for both coverage nodes, K5 fwd/bwd for the rotamer grid, K6
  for residue-plane BP);
* the fused block without its env band: ubiquitin without the
  environment/burial chain (as build_full_system builds it without an
  environment library; K1 fwd without planes, K3 the recomputing
  backward, K2), driven as MD and as parameter training (`fit_packed` of
  the rotamer table under the energy-gap loss, through K3 and the table
  cotangents);
* the replica-exchange path: BASELINE config 4 (tools/bench_all.py:
  103-160) on 104-residue horse cytochrome c (489 beads; K1 fwd, K1 bwd,
  K2), a Hamiltonian ensemble of 64 replicas under a +-1% ladder of the
  first spring node's spring_const at temperatures 0.80 1.02^i, even/odd
  swap sets every 10 rounds, through `cli.run_ensemble`; once more with
  pivot MC every 10 rounds and recentering at every frame;
* proteins past the kernels' caps: 164-residue T4 lysozyme (770 beads; K4
  and K5, and BP by the plain port of the XLA `_bp_solve`, the reference's
  own branch past 128 residues) and 238-residue GFP (1,143 beads; the
  fixed-K neighbour lists of the rotamer grid and both coverages, plain
  PyTorch as the reference's are XLA, and the plain BP solve);
* the node types the older bundles do not use, on the fused path:
  BASELINE config 2 (ubiquitin with sidechain_radial packing; K1 fwd, K1
  bwd, K2), BASELINE config 5 (chi1 prediction on ubiquitin through
  `chi1.predict_chi1_from_bundle`; K1 fwd, K2) and trp-cage with every
  config-builder extra plus the hand-built graph of the types no builder
  writes (`config/extras_graph.py`; K1 fwd, K1 bwd, K2);
* the command line and its trajectory files: `cli.main` on ubiquitin at
  64 slots and on config 4 (K1 fwd, K1 bwd, K2), through the per-node
  streams and the numpy-only HDF5 writer;
* `.up` configurations read without h5py (`config/reader.py`): the
  committed ubiquitin `.up` against the bundle of the same build, and
  `cli.main` on it at 64 slots (K1 fwd, K1 bwd, K2).

All use synthetic parameter libraries and a random initial structure from
the bundle's seed.  Phases:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles upside_md_torch/csrc/*.cu with nvcc for sm_90a, one
   process per source, all started together;
3. kernel vs plain PyTorch at each path's shapes (4 replicas, perturbed
   positions): forwards rel 1e-5, backwards under a random cotangent rel
   1e-4, BP at tol 1e-6 and at MD's 1e-3, cold and warm (F, gradients,
   beliefs and messages rel 1e-4; sweep counts equal to the plain solve's
   at 1e-3 and on the synthetic cases, printed at 1e-6, where float32
   rounding of the deviation decides the stop; bitwise repeatable
   twice over, the kernel's compact edge list, reverse and factor indices
   equal to the plain `compact_edges`, each replica's solve in the layout
   `solve_layout` gives for its edge count; prints each bundle's edge
   counts and the layout its solve blocks took), the same on the synthetic
   BP cases the bundles do not reach (`ops/bp_cases.py`: three beads in a
   rotamer slot, 128 residues, enough edges for the solve's layouts 1 and
   2, mixed batches whose replicas stop after different sweep counts, one
   without any edge; sweep counts equal at their tol 1e-4, values also at
   1e-6), and the whole evaluation's
   energy and force RMS against `kernels=False` (rel < 1e-3); K1's
   compact residual (counts and codes equal to `pack_residuals` of the
   plain forward, values rel 1e-5), its backward from that residual
   against the plain one from the dense planes, the block's round trip
   (outputs and input gradients through autograd), both K1 kernels
   bitwise repeatable and the backward unmoved by NaN/Inf in dead slots;
   K3 at both band layouts (bitwise repeatable, and unmoved by NaN/Inf in
   dead slots of the grid cotangent), and `param_deriv` of the rotamer,
   both coverage and (env bundle) environment tables against
   `kernels=False` (rel < 1e-3); the tile decisions of K1's forward, K3's,
   K4's and K5's forward and backward cull equal to their plain
   `cull_tiles`, bit for bit, K5's forward grid exactly 0 wherever the
   plain version has no live pair, and K5's backward unmoved by NaN in
   dead slots of its grid cotangent;
4. times each kernel and its plain version with CUDA events around one
   wrapper call on an idle card (median; `ms`, host side included) at 64
   replicas, and sums the device time of the call's kernels and memsets
   as `torch.profiler` records them (`device_ms`), beside its bound: the
   larger of the bytes it must move over the card's memory rate and the
   operations this run's data needs over the card's float32 rate (H100
   SXM data sheet), both counted over the pairs and edges this run's data
   needs (for the row-tile kernels, K1, K3, K4 and K5, only the pairs
   inside the cutoff, the packed mask the kernels read and, for K1 and
   K5's forward, the dense pair grid written once, for K1 the compact
   residual of the live pairs; the bound as
   counted before, with the geometry of every masked pair and for K1 the
   dense residual planes, is printed beside it and kept as
   `bound_table_ms` in the kernel table).  The BP kernels (K2, K6) are also timed at two fixed sweep
   counts with the convergence test off: the slope is the time of one
   dependent sweep, and that times the most sweeps a replica of the timed
   run took is their latency floor; and at 64 and 512 replicas (the
   64-replica inputs tiled), where the profiler's records of one call are
   split by pass: the launches before the solve (prologue), the solve
   with the Bethe edge pass, and the launches after (epilogue).  K1's
   forward and backward, K3, K4's and K5's forward and backward (the
   row-tile kernels with the per-replica cull, and K1's backward over
   the forward's residual) are timed at 64 and 512 replicas too, their
   device time split by launch, beside their bounds (K5's forward also
   beside a `zero_` of its grid: its bytes alone), with a `[cull]` line
   each: tiles walked out of all tiles and live pairs out of masked pairs
   (K5: also by row tile, a `[balance]` line), the kernel's
   decisions held to `cull_tiles` again (K1: and its residual to
   `pack_residuals`, both kernels against the plain versions on the first
   replicas); a `[resid]` line gives the bytes of K1's residual a replica
   against the dense planes', and K3 with the env band (the backward of
   `System(residuals=False)`) is timed beside K1's backward;
5. MD: `Simulation.advance` at 64 and 512 replicas on each path after a
   warm-up, the launch counts set to 0 just before each path and read just
   after; positions must stay finite and each path's kernels must have
   launched (and on the no-env path K1's plane-reading backward must not);
   prints steps/s and mean BP sweeps;
6. training: 5 Adam steps of `fit_packed` on 8 perturbed no-env
   ubiquitin configurations, counts set to 0 just before and read just
   after; every loss finite, the last below the first, K3 launched;
   prints seconds per step and the table cotangents' share of it;
7. replica exchange on cytochrome c: at 4 replicas under the stacked
   spring ladder the whole evaluation with kernels against
   `kernels=False` at BP tol 1e-6 (energy and force RMS rel < 1e-3) and
   each slot's energy against `System.energy` under that slot's own
   parameters (rel < 1e-5), with the ladder alone (one K1 launch for all
   slots) and with the rotamer pair table stacked too (one K1 launch a
   slot); then config 4 at 64 replicas, two warm-up exchange blocks and 60
   timed rounds (counts set to 0 just before, read just after): prints
   steps/s with the swaps (3 rounds replicas / wall time), swap
   acceptance, mean BP sweeps a force evaluation and K1 fwd, K1 bwd and
   K2 launches per evaluation; checks replica_index a permutation, the
   last exchange's energies equal to a fresh `potential_energy` (rel <
   1e-6), finite positions and momenta; the same run with pivot MC and
   recentering prints pivot acceptance and checks that a rejected pivot
   leaves its replica bitwise unchanged and the centres of mass below
   1e-4 A after recentering;
8. proteins past 128 residues and 1,024 beads, at full width:
   `[large t4_lysozyme]` the whole evaluation with kernels against
   `kernels=False` at BP tol 1e-6 (energy and force RMS rel < 1e-3), K4's
   and K5's forward and backward at 64 replicas against their plain
   versions (phase 4's tolerances, tile decisions equal to `cull_tiles`,
   device time by launch, bounds, the plain versions' time), MD at 64
   and 512 replicas; `[large gfp]` a whole evaluation on the card in
   float32 against the port on the CPU in float64 (no kernel lies on this
   path; same limits), MD at 64 replicas, for the rotamer grid and both
   coverages the largest in-cutoff partner count of a row beside the
   list's width K, and the device time of an evaluation's three
   neighbour-list calls, forward and backward, beside the MD's.  Each MD: 2 warm-up rounds, 3 x 3 timed rounds
   (steps/s, mean BP sweeps and host syncs of the plain solve an
   evaluation, peak memory), then 2 rounds under `torch.profiler` (device
   time an evaluation, idle share, the plain solve's share of device
   time); launch counts set to 0 just before each path and read just
   after: T4 lysozyme's K4 and K5 launched and no other kernel, GFP no
   kernel at all; GFP's evaluation is also held against the port on the
   CPU in float32 (printed, not gated: precision apart from fault);
9. the remaining node types, each gate card float32 against the port on
   the CPU in float64 at BP tol 1e-6 (energy and force RMS rel < 1e-3):
   `[config2 ubiquitin_radial]` BASELINE config 2, its fusion plan's
   node names equal to ubiquitin_full_synth's, the gate also against
   `kernels=False`, K1 fwd, K1 bwd and K2 once a force evaluation, MD at
   64 and 512 replicas (2 warm-up rounds, 3 x 3 timed rounds: steps/s,
   mean BP sweeps <= 4.01, ubiquitin_full_synth's
   beside it), a profiled round beside ubiquitin_full_synth's (device
   time, idle share, launches an evaluation) and `radial`'s share of
   device time; `[chi1 ubiquitin]` BASELINE config 5 through
   `chi1.predict_chi1_from_bundle` at 1 and 64 configurations (chi1
   probabilities within 1e-3 absolute of the CPU's, rows summing to 1
   within 2e-2, K1 fwd and K2 launched, K1 bwd not, the wall time of a
   prediction); `[extras trp_cage]` trp_cage_extras_synth and the
   hand-built graph on it (each new node type's energy or output with
   its error), MD at 64 replicas with AFM's energy after it against the
   CPU at the same force-evaluation counter (rel < 1e-5), a profiled
   round, and radial's and fixed_hmm's shares and device launches;
10. the command line (`python -m upside_md_torch.cli`, driven in
   process through `cli.main`), writing its per-slot HDF5 files with
   `io/h5.py` into a temporary directory: `[cli ubiquitin]` 64 slots of
   ubiquitin at the detailed log level, 60 rounds, frames every 10,
   beside a bare `run_ensemble` under the same schedule (K1 fwd, K1 bwd
   and K2 launched as often over as many evaluations; every file read
   back by the port's reader, every frame finite; the logged potential
   equal to `System.energy` at the logged positions, rel 1e-5; frame 1's
   streams of 4 slots equal to the port on the CPU in float64 within 1e-4
   of each stream's largest value, or of 1 where that is smaller;
   prints steps/s of both, ms a frame (the evaluation with its streams,
   the copies and the logging) beside the bare run's, bytes a frame a slot
   and ms a flush); `[cli rex cytochrome_c]` config 4 through the
   command line from 64 ladder bundles written with `bundle.save`, even/odd
   swap sets every 10 rounds, 40 rounds (replica_index a permutation in
   every frame; swap acceptance and steps/s beside phase 7's); `[cli pda]`
   --potential-deriv-agreement on ubiquitin (its value, finite);
11. `.up` configurations: `[up ubiquitin]` the committed
   `ubiquitin_full_synth.up` through `reader.load_up` (host ms beside
   `bundle.load` of the `.npz`, its HDF5 read of every dataset and its
   float64 fits timed apart; the records equal to the bundle's, the
   fitted coefficients within rel 1e-6; energy and force RMS of
   `System.from_up` against `System.from_bundle` at 64 replicas, rel
   1e-6); `[up rama]` `rama_map_pot`'s get_param on both systems (rel
   1e-6) and set_param(get_param()) (energy rel 1e-6); `[cli up
   ubiquitin]` `cli.main` on the `.up` at 64 slots, 60 rounds, frames
   every 10, beside the bundle's run in the order npz, up, up, npz (K1
   fwd, K1 bwd and K2 launched as by the bundle run; the frame-1
   potential rel 1e-6; steps/s of each);
12. prints the kernel table as one JSON line (launches summed over the
   paths that ran each kernel), the card's name and power limit, and last
   `{"ok": true, "device": {...}}`.

Every failed check raises and the script exits non-zero.  Run from the
repository root:

    python3 chip_smoke.py [--out DIR]

--out writes the full results as JSON into DIR.
"""

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = "ubiquitin_full_synth.npz"        # fused path (<= 512 beads)
BUNDLE_UNFUSED = "rnase_a_full_synth.npz"  # unfused path (543 beads)
BUNDLE_NOENV = "ubiquitin_noenv_synth.npz"  # fused block, no env band
BUNDLE_REX = "cytochrome_c_full_synth.npz"  # replica exchange (489 beads)
BUNDLE_T4 = "t4_lysozyme_full_synth.npz"   # 164 residues: plain BP solve
BUNDLE_GFP = "gfp_full_synth.npz"          # 1,143 beads: neighbour lists
T4_SIZE, GFP_SIZE = (164, 770), (238, 1143)  # rotamer residues, beads
KERNEL_INFO = {
    "fused_pair_fwd": ("upside_md_torch/csrc/fused_pair_fwd.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:1021"),
    "fused_pair_bwd": ("upside_md_torch/csrc/fused_pair_bwd.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:1276"),
    "fused_pair_bwd_recompute": (
        "upside_md_torch/csrc/fused_pair_bwd.cu",
        "upside_md_tpu/ops/pallas_quadspline.py:1132"),
    "bp_bethe_pairs": ("upside_md_torch/csrc/bp_bethe_pairs.cu",
                       "upside_md_tpu/ops/pallas_bp.py:965"),
    "quadspline_fwd": ("upside_md_torch/csrc/quadspline.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:248"),
    "quadspline_bwd": ("upside_md_torch/csrc/quadspline.cu",
                       "upside_md_tpu/ops/pallas_quadspline.py:277"),
    "colsum_fwd": ("upside_md_torch/csrc/quadspline.cu",
                   "upside_md_tpu/ops/pallas_quadspline.py:356"),
    "colsum_bwd": ("upside_md_torch/csrc/quadspline.cu",
                   "upside_md_tpu/ops/pallas_quadspline.py:390"),
    "bp_bethe_planes": ("upside_md_torch/csrc/bp_bethe_planes.cu",
                        "upside_md_tpu/ops/pallas_bp.py:230"),
}
FUSED_KERNELS = ("fused_pair_fwd", "fused_pair_bwd", "bp_bethe_pairs")
UNFUSED_KERNELS = ("quadspline_fwd", "quadspline_bwd", "colsum_fwd",
                   "colsum_bwd", "bp_bethe_planes")
# T4 lysozyme's path: K4 and K5; its BP is the plain solve, past K6's cap
LARGE_KERNELS = UNFUSED_KERNELS[:4]
NOENV_KERNELS = ("fused_pair_fwd", "fused_pair_bwd_recompute",
                 "bp_bethe_pairs")
TRAIN_CONFIGS, TRAIN_STEPS, TRAIN_LR = 8, 5, 0.03
PARAM_SWEEPS = 100   # fixed BP sweeps of the param_deriv comparison
# the burial coupling's spline offset for the environment-table gradient
# check: with the synthetic library's 0 the coverages sit on the clamped
# flat start of the coupling spline and every burial gradient is 0
COUPLING_OFFSET = -4.0

# H100 SXM peaks (NVIDIA data sheet): device memory and float32 outside the
# tensor cores, the type every kernel here computes in
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per pair or edge, counted from the kernel sources
# (an FMA counts 2): pair geometry; spline value (4 segments, Horner);
# value with the derivative planes; recomputing backward; K1's env pair
# forward and backward; K1's plane-consuming backward; one BP sweep per
# directed edge (edge and node update); the Bethe pass per undirected edge
OPS_GEOM, OPS_VALUE, OPS_PLANES, OPS_BWD = 27, 80, 110, 150
OPS_ENV_FWD, OPS_ENV_BWD, OPS_PLANE_BWD = 46, 70, 45
OPS_SWEEP_EDGE, OPS_BETHE_EDGE = 110, 540
COMPARE_REPLICAS, TIME_REPLICAS, MD_REPLICAS = 4, 64, (64, 512)
# BASELINE config 4 (tools/bench_all.py:103-160): replicas, timed rounds,
# rounds between exchanges (and frames, and pivot moves), warm-up blocks
REX_REPLICAS, REX_ROUNDS, REX_EVERY, REX_WARMUP_BLOCKS = 64, 60, 10, 2
# phase 8's MD: replicas, timed rounds (three times), profiled rounds
T4_MD_REPLICAS, GFP_MD_REPLICAS, LARGE_ROUNDS = (64, 512), (64,), 3
LARGE_PROFILE_ROUNDS = 2
# phase 9: the remaining node types
BUNDLE_RADIAL = "ubiquitin_radial_synth.npz"   # BASELINE config 2
BUNDLE_CHI1 = "ubiquitin_chi1_synth.npz"       # BASELINE config 5
BUNDLE_EXTRAS = "trp_cage_extras_synth.npz"    # every builder extra
CHI1_CONFIGS = (1, 64)
EXTRAS_REPLICAS, MD_ROUNDS_EXTRAS = 64, 3
N_DERIV_EVALS = 7     # the force-evaluation counter of the extras gate
PROFILE_ROUNDS = 1
# phase 10: the command line (slots, rounds, frame interval; config 4's
# rounds; slots whose frame-1 streams are recomputed on the CPU)
CLI_SLOTS, CLI_ROUNDS, CLI_EVERY, CLI_REX_ROUNDS = 64, 60, 10, 40
CLI_HOST_SLOTS = 4
CLI_APPEND_FRAMES = 300     # three flushes: one creating, two appending
# phase 11: the committed .up of ubiquitin_full_synth's build; host calls
# timed a load; fitted coefficients against the bundle's (one float32
# rounding) and evaluations from the .up against the bundle's
BUNDLE_UP = "ubiquitin_full_synth.up"
UP_LOAD_REPS = 3
UP_FIT_TOL, UP_EVAL_TOL = 1e-6, 1e-6
SWEEPS_LO, SWEEPS_HI = 10, 50    # fixed sweep counts of the latency slope
BP_TIME_REPLICAS = (64, 512)     # K2 and K6 are timed by pass at both
ROW_TILE_REPLICAS = (64, 512)    # the row-tile kernels, by launch, at both
# The bundles' BP kernels are held against their plain versions at tol 1e-6
# (values; the deviation's float32 rounding, a few 1e-6 at 76-124 residues,
# decides there when either version stops, so sweep counts are printed) and
# at the tol MD runs with, 1e-3, where the sweep counts must be equal too.
BP_COMPARE_TOLS = (1e-6, 1e-3)
BP_SWEEPS_TOL = 1e-4
# mean BP sweeps per evaluation of the ubiquitin MD paths must not rise
# above what the solver took before its redesign
MAX_MEAN_SWEEPS = 3.99
# config 2 (ubiquitin with sidechain_radial packing) over its 3 x 3 timed
# rounds: about two of the solver's 2-sweep chunks an evaluation (on an
# NVIDIA H100 80GB HBM3 at 700 W it took 4.0000 at 64 replicas and 4.0017
# at 512, ubiquitin without radial 4.0000 and 4.0009 under the same
# schedule, which is printed beside it); checked on two decimals, as
# MAX_MEAN_SWEEPS
CONFIG2_MAX_SWEEPS = 4.01


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
    """Median time of fn() between two CUDA events on an idle card: a call
    whose host side (allocations, several launches) is slower than its
    kernels is timed at the host's pace."""
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


def device_events(fn, reps=20):
    """[(name, device microseconds)] of every kernel and memset that `reps`
    calls of fn() ran, in the order the card ran them (`torch.profiler`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.device_time) for e in ev]


def device_ms(fn, reps=20):
    """Device time of one call of fn(): its kernels' and memsets' times
    summed, without the gaps between launches.  None where the profiler
    recorded no device activity."""
    ev = device_events(fn, reps)
    return sum(t for _, t in ev) / reps * 1e-3 if ev else None


def timed(kernel_fn, plain_fn):
    """(ms, plain ms, device ms) of a kernel's wrapper call."""
    return (cuda_ms(kernel_fn), cuda_ms(plain_fn, reps=5),
            device_ms(kernel_fn))


def check(name, err, tol):
    log(f"  {name}: rel err {err:.3e} (tol {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: rel err {err} >= {tol}")


def compare(label, got, want, tol):
    """Checks each (name, kernel, plain) triple; returns the max abs err."""
    worst = 0.0
    for nm, a, b in zip(label, got, want):
        e, d = rel_err(a, b)
        check(nm, e, tol)
        worst = max(worst, d)
    return worst


def repeatable(name, a, b):
    if not all(x.equal(y) for x, y in zip(a, b)):
        raise AssertionError(f"{name} is not deterministic on identical "
                             "inputs")


def compare_grid(name, got, want, live):
    """K5's forward grid against the plain one: rel 1e-5, and exact zeros
    wherever the plain version has no live pair (`live`: its
    `live_pairs`); logs the live pairs whose value is 0 in one grid and
    not in the other (a spline that vanishes there, rounded apart).
    Returns the max abs err."""
    import torch
    if (got[~live] != 0).any():
        raise AssertionError(f"{name}: {int((got[~live] != 0).sum())} "
                             "elements without a live pair are not 0")
    odd = live & ((got == 0) != (want == 0))
    if odd.any():
        log(f"  {name}: {int(odd.sum())} live pairs 0 in one grid only, "
            f"the other's largest there {float(want[odd].abs().max()):.3e} "
            f"/ {float(got[odd].abs().max()):.3e}")
    return compare([name], (got,), (want,), 1e-5)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, n_ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def spline_pairs(ps, tab, x1, x2):
    """(pairs in the mask, pairs also inside the cutoff), over replicas."""
    from upside_md_torch.ops.quadspline import live_pairs
    return (int(ps.mask.sum()) * x1.shape[0],
            int(live_pairs(ps, tab, x1, x2).sum()))


def as_before(b):
    """', as counted before x ms (by)' for a bound that changed: with the
    geometry of every masked pair and, for K1, the dense residual planes."""
    return "" if b is None else \
        f", as counted before {b[0]:.4f} ms ({b[1]})"


def bp_ops(adj, iters):
    """BP work this run's data needs: sweeps over directed edges, then the
    Bethe pass over undirected ones."""
    edges = adj.sum((1, 2)).double()
    return float((edges * (OPS_SWEEP_EDGE * iters.double()
                           + OPS_BETHE_EDGE / 2)).sum())


def bp_bound(adj, warm, out, pair_bytes, *dense):
    """K2's or K6's bound: the dense inputs and every output moved once,
    the pair factors (`pair_bytes`, counted by the caller) and the warm
    messages only on the adjacent directed edges of `adj` (no diagonal),
    which is all the solve reads of them."""
    return bound(nbytes(*dense, warm[0], *out) + pair_bytes
                 + int(adj.sum()) * 6 * warm[1].element_size(),
                 bp_ops(adj, out[6]))


def sweep_latency(run, st, iters):
    """(ms per dependent sweep, latency floor ms): the device time of
    `run(st)` at two fixed sweep counts with the convergence test off (the
    call on an idle card where the profiler records nothing), and the
    slope times the most sweeps a replica of the timed run took (its block
    ends last)."""
    def ms(max_iter):
        s_ = dataclasses.replace(st, max_iter=max_iter, tol=-1.0)
        t = device_ms(lambda: run(s_))
        return cuda_ms(lambda: run(s_)) if t is None else t

    t_lo, t_hi = ms(SWEEPS_LO), ms(SWEEPS_HI)
    per = (t_hi - t_lo) / (SWEEPS_HI - SWEEPS_LO)
    return per, per * int(iters.max())


def check_bp(label, run, plain, adj, shared, equal_sweeps=True):
    """K2 or K6 against its plain version, cold and then warm from the cold
    solution: `run(warm, init)` -> (outputs, scratch) and `plain(warm,
    init)` -> outputs choose the warm problem themselves; `adj` is the
    dense adjacency (no diagonal), `shared` whether factor blocks are per
    undirected pair (K2).  Sweep counts equal (unless `equal_sweeps` is
    off: at a tolerance below the float32 rounding of the deviation, a few
    1e-6 at these sizes, rounding decides when either version stops, and
    they are only printed); F, both gradients, beliefs and messages rel
    1e-4; bitwise repeatable twice over; each replica's solve in the
    layout `solve_layout` gives for its edge count; the compact edge list,
    reverse and factor indices equal to `compact_edges`.  Returns (max abs
    err over F and the gradients, counts (B, 4) of the cold run, cold sweep
    counts)."""
    import torch
    from upside_md_torch.ops.bp_pairs import compact_edges, solve_layout
    cnt, edges, rev, pair = compact_edges(adj)
    worst, init, first = 0.0, None, None
    for warm in (False, True):
        tag = f"{label} {'warm' if warm else 'cold'}"
        k, sc = run(warm, init)
        for _ in range(2):
            repeatable(tag, k, run(warm, init)[0])
        p = plain(warm, init)
        torch.cuda.synchronize()
        log(f"  {tag} sweeps kernel {k[6].tolist()} plain {p[6].tolist()}, "
            f"final dev kernel {k[5].max().item():.2e} plain "
            f"{p[5].max().item():.2e}")
        if equal_sweeps and k[6].tolist() != p[6].tolist():
            raise AssertionError(f"{tag}: sweep counts differ")
        worst = max(worst, compare(
            [f"{tag} {n}" for n in ("F", "G1", "pair gradient")], k[:3],
            p[:3], 1e-4))
        compare([f"{tag} beliefs", f"{tag} messages"], k[3:5], p[3:5], 1e-4)
        counts = sc.counts.cpu()
        n_edges = counts[:, 0].tolist()
        n_blocks = counts[:, 1].tolist() if shared else n_edges
        if n_edges != cnt.tolist():
            raise AssertionError(f"{tag}: edge counts {n_edges} != plain "
                                 f"{cnt.tolist()}")
        for r, n in enumerate(n_edges):
            same = sc.edges[r, :n].equal(edges[r, :n]) \
                and sc.reverse[r, :n].equal(rev[r, :n]) \
                and (not shared or sc.pair_index[r, :n].equal(pair[r, :n]))
            if not same:
                raise AssertionError(f"{tag}: compact edges of replica {r} "
                                     "differ from compact_edges")
        want = [solve_layout(e, f) for e, f in zip(n_edges, n_blocks)]
        if counts[:, 2].tolist() != want:
            raise AssertionError(f"{tag}: layouts {counts[:, 2].tolist()} "
                                 f"!= {want}")
        if first is None:
            first = (counts, k[6].tolist())
        init = (k[3], k[4])
    log(f"  {label}: compact edges, reverse and factor indices equal "
        f"compact_edges; layouts {sorted(set(first[0][:, 2].tolist()))}; "
        "repeatable")
    return worst, first[0], first[1]


def check_k2(label, st, E1, E_pair, adj):
    """`check_bp` of K2 at each of BP_COMPARE_TOLS, warm from the cold
    solution on the problem with E1 scaled by 0.98.  Returns (max abs err,
    counts of the last run)."""
    from upside_md_torch.ops.bp_pairs import (bp_bethe_pairs_fwd,
                                              bp_pairs_kernel)
    worst = 0.0
    for tol in BP_COMPARE_TOLS:
        s_ = dataclasses.replace(st, tol=tol)
        err, counts, _ = check_bp(
            f"{label} tol {tol:g}", lambda w, init: bp_pairs_kernel(
                s_, E1 * (0.98 if w else 1.0), E_pair, init),
            lambda w, init: bp_bethe_pairs_fwd(
                s_, E1 * (0.98 if w else 1.0), E_pair, init, plain=True),
            adj, True, equal_sweeps=tol >= BP_SWEEPS_TOL)
        worst = max(worst, err)
    return worst, counts


def log_layout(label, counts, n_rep):
    """Edge counts of a bundle and the layout its solve blocks took."""
    from upside_md_torch.ops.bp_pairs import LAYOUTS, SOLVE_SMEM_BYTES
    e, u, lay = (counts[:, c].tolist() for c in range(3))
    log(f"[layout] {label}: adjacent directed edges {min(e)}-{max(e)} "
        f"({n_rep} replicas); with {SOLVE_SMEM_BYTES} bytes of shared "
        f"memory a block the solve ran with "
        f"{'; '.join(LAYOUTS[i] for i in sorted(set(lay)))}")
    return {"directed_edges": e, "undirected_pairs": u, "layout_ran": lay}


def time_bp_passes(label, fwd, n_rep):
    """`time_launches` of one wrapper call `fwd()` of K2 or K6, its device
    time also split by pass: what runs before `bp_solve_kernel` is the
    prologue, the solve and `bp_bethe_edges_kernel` the solve, what
    follows up to the call's last launch (`bp_messages_kernel`) the
    epilogue."""
    after_solve = False

    def pass_of(name):
        nonlocal after_solve
        if "bp_solve_kernel" in name or "bp_bethe_edges_kernel" in name:
            after_solve = True
            return "solve"
        key = "epilogue" if after_solve else "prologue"
        if "bp_messages_kernel" in name:
            after_solve = False
        return key

    rec = time_launches(label, fwd, n_rep, pass_of,
                        ("prologue", "solve", "epilogue"))
    return {**{k: v for k, v in rec.items() if k != "pass_ms"},
            **{f"{k}_ms": v for k, v in rec["pass_ms"].items()}}


def tiled(t, k):
    return t.repeat(k, *([1] * (t.dim() - 1)))


def perturbed(base, n, gen, dev):
    import torch
    return base[None] + 0.1 * torch.randn((n,) + base.shape, generator=gen,
                                          device=dev)


def load_system(path, dev, kernels=True, tol=None, coupling_offset=None,
                max_iter=None, dtype="float32", specs=None):
    """(System, initial positions) of a bundle, or of `specs` (bundle
    records) with the bundle's positions, on `dev` in `dtype`."""
    import torch
    from upside_md_torch.config import bundle
    from upside_md_torch.system import System
    recs, pos0 = bundle.load(path)
    specs = recs if specs is None else specs
    for s in specs:
        if s.type_name == "rotamer" and tol is not None:
            s.consts["tol"] = tol
        if s.type_name == "rotamer" and max_iter is not None:
            s.consts["max_iter"] = max_iter
        if s.type_name == "nonlinear_coupling" and coupling_offset is not None:
            s.consts["spline_offset"] = coupling_offset
    return System(len(pos0), specs, dev, getattr(torch, dtype), kernels), \
        pos0


def host_system(path, dtype, specs=None):
    """The port on the CPU at BP tol 1e-6: what the card is held to."""
    return load_system(path, "cpu", tol=1e-6, dtype=dtype, specs=specs)[0]


def compare_k3(label, prep, x, plain_fwd, randn):
    """K3 against its plain version under a random cotangent (rel 1e-4),
    bitwise repeatable, and unmoved by NaN/Inf in the dead slots of the
    grid cotangent (the padding, masked pairs, pairs beyond the cutoff):
    the port's copy of the poisoned-dead-slot test on the card."""
    import torch
    from upside_md_torch.ops.fused_pair import (cull_tiles,
                                                fused_pair_bwd_recompute)
    g = [randn(t) for t in plain_fwd[:3]]
    keep = cull_tiles(prep, x[0], x[2])
    flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=keep.device)
    bk = fused_pair_bwd_recompute(prep, *x, *g, flags=flags)
    repeatable(f"K3 {label}", bk, fused_pair_bwd_recompute(prep, *x, *g))
    masked, live, _ = fused_pairs(prep, x[0], x[2])
    check_cull(f"K3 {label}, {x[0].shape[0]} replicas", flags, keep, live,
               masked)
    bp = fused_pair_bwd_recompute(prep, *x, *g, plain=True)
    torch.cuda.synchronize()
    err = compare([f"K3 {label} d1", f"K3 {label} d2"], bk, bp, 1e-4)
    n2 = prep.n2
    gg = g[1].clone()
    gg[:, n2:] = float("nan")
    gg[:, :, n2:] = float("inf")
    inner = gg[:, :n2, :n2]
    inner[~fused_live(prep, x[0], x[2])[1][:, prep.r_p:]] = float("nan")
    dirty = fused_pair_bwd_recompute(prep, *x, g[0], gg, g[2])
    if not all(torch.isfinite(a).all() and a.equal(b)
               for a, b in zip(dirty, bk)):
        raise AssertionError(f"K3 {label}: non-finite cotangents in dead "
                             "slots moved the result")
    log(f"  K3 {label}: bitwise repeatable; NaN/Inf in dead grid slots "
        "leave it unchanged")
    return err


def compare_param_deriv(path, dev, pos, label, nodes):
    """System.param_deriv of each node's table, kernels against
    kernels=False, rel < 1e-3, with BP run for PARAM_SWEEPS sweeps and its
    convergence test off, so both versions take the same schedule.  (With
    a convergence test the two can stop a chunk apart, float32 noise
    deciding, and the table gradients, which read the beliefs, then differ
    by up to the BP tolerance: 2.1e-3 at tol 1e-3 in one run.)  Returns
    the max abs err."""
    sys_k, _ = load_system(path, dev, True, -1.0, COUPLING_OFFSET,
                           PARAM_SWEEPS)
    sys_p, _ = load_system(path, dev, False, -1.0, COUPLING_OFFSET,
                           PARAM_SWEEPS)
    worst = 0.0
    for node in nodes:
        a = sys_k.param_deriv(pos, node)["interaction_param"]
        b = sys_p.param_deriv(pos, node)["interaction_param"]
        if not b.abs().max().item() > 0:
            raise AssertionError(f"{label} param_deriv {node} is all 0")
        e, d = rel_err(a, b)
        check(f"{label} param_deriv {node}", e, 1e-3)
        worst = max(worst, d)
    return worst


def fused_live(prep, x1, x2):
    """(n1, n2) pairs of the spline bands' mask and (B, n1, n2) those also
    inside their band's cutoff (`live_pairs`, the kernels' exact test):
    the pairs the fused kernels evaluate."""
    from upside_md_torch.ops.fused_pair import live_pairs
    spline = prep.mask.bool() & (prep.band_of_rows() != 2)[:, None]
    return spline, live_pairs(prep, x1, x2)


def fused_pairs(prep, x1, x2):
    """(pairs in the spline bands' mask, those also inside their band's
    cutoff, those of the pair band inside it), summed over replicas."""
    spline, live = fused_live(prep, x1, x2)
    return (int(spline.sum()) * x1.shape[0], int(live.sum()),
            int(live[:, prep.r_p:].sum()))


def check_cull(label, flags, keep, live, masked):
    """The row-tile kernel's tile decisions (`flags`, as it wrote them)
    against `keep`, its plain `cull_tiles`, bit for bit; logs the `[cull]`
    line (tiles walked, tiles whose column partials the kernel wrote, live
    pairs out of masked ones)."""
    import torch
    from upside_md_torch.ops.tile_cull import KEPT, WRITTEN
    kept = (flags & KEPT) != 0
    written = (flags & WRITTEN) != 0
    if not torch.equal(kept, keep):
        raise AssertionError(f"{label}: the kernel's tile cull differs from "
                             f"cull_tiles in {int((kept != keep).sum())} "
                             "tiles")
    if (written & ~kept).any():
        raise AssertionError(f"{label}: partials written for a culled tile")
    rec = {"tiles": kept.numel(), "kept": int(kept.sum()),
           "written": int(written.sum()), "masked_pairs": masked,
           "live_pairs": live}
    log(f"[cull] {label}: tiles walked {rec['kept']} of {rec['tiles']} "
        f"({rec['kept'] / rec['tiles']:.3f}), column partials written "
        f"{rec['written']}; live pairs {live} of {masked} masked "
        f"({live / max(masked, 1):.4f}); equal to cull_tiles")
    return rec


def time_launches(label, fn, n_rep, pass_of=None, passes=()):
    """One wrapper call `fn()`: the CUDA-event median on an idle card, and
    the device time of its launches from the profiler, split by launch;
    with `pass_of`, which names the pass (one of `passes`) of each launch
    the card ran, in order, also split by pass (`pass_ms`)."""
    import torch
    reps = 20
    alone = cuda_ms(fn, reps)
    by_launch, by_pass = {}, dict.fromkeys(passes, 0.0)
    for name, us in device_events(fn, reps):
        short = name.split("(")[0].replace("void ", "").strip()
        by_launch[short] = by_launch.get(short, 0.0) + us / reps
        if pass_of is not None:
            by_pass[pass_of(name)] += us / reps * 1e-3
    total = sum(by_launch.values()) * 1e-3 if by_launch else None
    split = "".join(f", {k} {v:.4f}" for k, v in by_pass.items())
    log(f"[time] {label} at {n_rep} replicas: {alone:.4f} ms a call on an "
        f"idle card; device time of its launches "
        f"{'not measured' if total is None else f'{total:.4f} ms'}"
        f"{split}; by launch (us) "
        f"{ {k: round(v, 2) for k, v in by_launch.items()} }")
    torch.cuda.empty_cache()
    rec = {"ms": alone, "device_ms": total, "launch_us": by_launch}
    if pass_of is not None:
        rec["pass_ms"] = by_pass
    return rec


# ---------------------------------------------------------------------------
# the fused path (ubiquitin): K1 fwd, K1 bwd, K2
# ---------------------------------------------------------------------------

def fused_operands(system, outs, gen, dev):
    import torch
    from upside_md_torch.nodes.rotamer import assemble_one_body
    plan = system.pair_fusion
    prep = system.fused_prepared()
    x1, w1, x2, wcol = plan.block_inputs(system.consts, outs)
    rot = plan.rot
    E1 = assemble_one_body(system.consts[rot.name],
                           [outs[a] for a in rot.args])
    return dict(prep=prep, x=(x1, w1, x2, wcol), E1=E1,
                st=system.consts[rot.name]["bp"],
                randn=lambda t: torch.randn(t.shape, generator=gen,
                                            device=dev))


def check_residual(label, prep, x, packed, planes, vcov):
    """K1 forward's compact residual against `pack_residuals` of the plain
    forward's dense planes at the same sites: counts and codes equal,
    values rel 1e-5.  Returns the max abs err of the values."""
    import torch
    from upside_md_torch.ops.fused_pair import pack_residuals, residual_slots
    want = pack_residuals(prep, x[0], x[2], planes, vcov)
    valid = residual_slots(want.counts)
    if not torch.equal(packed.counts, want.counts):
        raise AssertionError(f"{label}: residual counts differ from "
                             "pack_residuals in "
                             f"{int((packed.counts != want.counts).sum())} "
                             "tiles")
    if not torch.equal(packed.codes[valid], want.codes[valid]):
        raise AssertionError(f"{label}: residual codes differ from "
                             "pack_residuals")
    err = compare([f"{label} residual values"], [packed.vals[valid]],
                  [want.vals[valid]], 1e-5)
    log(f"  {label}: residual counts and codes equal pack_residuals "
        f"({int(want.counts.sum())} live pairs)")
    return err


def residual_bytes(prep, packed):
    """(bytes of the live pairs' residual, of its allocation, of the dense
    planes and vcov it stands for), per replica."""
    B = packed.counts.shape[0]
    live = int(packed.counts.sum())
    used = nbytes(packed.counts) + live * (packed.codes.element_size()
                                          + 4 * packed.vals.element_size())
    dense = (3 * prep.n1 + prep.r_e) * prep.n2 * 4
    return used / B, nbytes(*packed) / B, dense


def compare_k1(label, prep, x, randn, first=None):
    """K1's forward and backward kernels against their plain versions on
    the replicas `first` (all: None): cov, E_pair, env rel 1e-5, the
    compact residual (`check_residual`), the cull's decisions equal to
    `cull_tiles` (a `[cull]` line), the backward from the kernel's
    residual rel 1e-4 against the plain one from the dense planes, both
    bitwise repeatable twice over, and the backward unmoved by NaN/Inf in
    the dead slots of the grid cotangent and in the coverage cotangents of
    columns no live coverage pair reads.  Returns (max abs err forward,
    backward, the cull record, the kernel's forward, the cotangents)."""
    import torch
    from upside_md_torch.ops.fused_pair import (cull_tiles, fused_pair_bwd,
                                                fused_pair_fwd)
    n = x[0].shape[0]
    sl = slice(None) if first is None else slice(0, first)
    tag = f"K1 {label}, {n} replicas" + ("" if first is None else
                                         f", the first {first}")
    keep = cull_tiles(prep, x[0], x[2])
    flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=keep.device)
    fk = fused_pair_fwd(prep, *x, flags=flags)
    for _ in range(2):
        again = fused_pair_fwd(prep, *x)
        repeatable(f"{tag} fwd", fk[:3] + (fk[3].counts,),
                   again[:3] + (again[3].counts,))
    spline, lv = fused_live(prep, x[0], x[2])
    pairs = (int(spline.sum()) * n, int(lv.sum()), int(lv[:, prep.r_p:].sum()))
    rec = check_cull(f"{tag} fwd", flags, keep, pairs[1], pairs[0])
    rec["live_grid_pairs"] = pairs[2]
    xf = [t[sl] for t in x]
    fp_ = fused_pair_fwd(prep, *xf, plain=True)
    torch.cuda.synchronize()
    err_f = compare([f"{tag} fwd {nm}" for nm in ("cov", "E_pair", "env")],
                    [t[sl] for t in fk[:3]], fp_[:3], 1e-5)
    err_f = max(err_f, check_residual(f"{tag} fwd", prep, xf,
                                      type(fk[3])(*(t[sl] for t in fk[3])),
                                      *fp_[3]))
    g = [randn(t) for t in fk[:3]]
    bk = fused_pair_bwd(prep, *x, fk[3], *g)
    for _ in range(2):
        repeatable(f"{tag} bwd", bk, fused_pair_bwd(prep, *x, fk[3], *g))
    bp = fused_pair_bwd(prep, *xf, fp_[3], *(t[sl] for t in g), plain=True)
    torch.cuda.synchronize()
    err_b = compare([f"{tag} bwd d1", f"{tag} bwd d2"],
                    [t[sl] for t in bk], bp, 1e-4)
    g_cov, g_grid = g[0].clone(), g[1].clone()
    g_grid[:, prep.n2:] = float("nan")
    g_grid[:, :, prep.n2:] = float("inf")
    g_grid[:, :prep.n2, :prep.n2][~lv[:, prep.r_p:]] = float("nan")
    for band, (lo, hi) in enumerate(((0, prep.r_b), (prep.r_b, prep.r_e))):
        g_cov[:, band][~lv[:, lo:hi].any(1)] = float("nan")
    dirty = fused_pair_bwd(prep, *x, fk[3], g_cov, g_grid, g[2])
    if not all(torch.isfinite(a).all() and a.equal(b)
               for a, b in zip(dirty, bk)):
        raise AssertionError(f"{tag}: non-finite cotangents in dead slots "
                             "moved K1's backward")
    log(f"  {tag}: bitwise repeatable; NaN/Inf in dead grid and coverage "
        "slots leave the backward unchanged")
    return err_f, err_b, rec, fk, g


def compare_fused(dev, gen, base, path):
    import torch
    from upside_md_torch.ops.bp_pairs import scatter_pairs
    from upside_md_torch.ops.fused_pair import fused_pair_block, fused_pair_fwd
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    o = fused_operands(sys_k, outs, gen, dev)
    prep, x = o["prep"], o["x"]
    log(f"[compare ubiquitin] rows {prep.n1} (hbond {prep.r_b}, hydrophobe "
        f"{prep.r_e - prep.r_b}, env {prep.n_e}, beads {prep.n2}) x "
        f"{prep.n2} columns, {COMPARE_REPLICAS} replicas")
    errs = {}
    errs["fused_pair_fwd"], errs["fused_pair_bwd"], _, _, _ = compare_k1(
        "ubiquitin", prep, x, o["randn"])
    # the block's round trip: outputs and input gradients, kernels
    # against the plain version
    trip = []
    for plain in (False, True):
        xs = [t.detach().clone().requires_grad_(True) for t in x]
        out = fused_pair_block(prep, *xs, plain=plain)
        if not trip:
            gb = [o["randn"](t) for t in out]
        sum((a * b).sum() for a, b in zip(out, gb)).backward()
        trip.append([t.detach() for t in out] + [t.grad for t in xs])
    torch.cuda.synchronize()
    compare([f"K1 block round trip {nm}" for nm in (
        "cov", "E_pair", "env", "d x1", "d w1", "d x2", "d wcol")],
        trip[0], trip[1], 1e-4)
    fp_ = fused_pair_fwd(prep, *x, plain=True)
    errs["fused_pair_bwd_recompute"] = compare_k3("env band", prep, x, fp_,
                                                  o["randn"])
    errs["param_deriv"] = compare_param_deriv(
        path, dev, pos, "ubiquitin", ("rotamer", "hbond_coverage",
                                      "hbond_coverage_hydrophobe",
                                      "environment_coverage"))

    st, E1, E_pair = o["st"], o["E1"], fp_[1]
    eye = torch.eye(st.n_res, dtype=torch.bool, device=dev)
    adj = (scatter_pairs(st, E_pair) != 0).any(-1).any(-1) & ~eye
    errs["bp_bethe_pairs"], counts = check_k2("K2", st, E1, E_pair, adj)
    layout = log_layout("K2 ubiquitin", counts, COMPARE_REPLICAS)
    whole = compare_whole(sys_k, sys_p, pos, "ubiquitin")
    return errs, whole, layout


def k1_bounds(prep, x, fk, g, d, live, live_grid, env_pairs):
    """K1's bounds, forward and backward, from this run's data: the live
    pairs' work and the env pairs', each input read once (the packed mask
    words, the compact residual of the live pairs, the grid cotangent only
    where a live pair reads it) and each output written once (the dense
    E_pair grid once); and as they were counted before, kept to compare
    with: the geometry and spline terms of every spline pair, the dense
    uint8 mask and the dense residual planes."""
    B = x[0].shape[0]
    res = nbytes(fk[3].counts) + live * (
        fk[3].codes.element_size() + 4 * fk[3].vals.element_size())
    dense = B * (3 * prep.n1 + prep.r_e) * prep.n2 * 4
    common = nbytes(*x, prep.row_type, prep.col_type, prep.env_tab)
    fwd_out = nbytes(*fk[:3])
    bwd_io = nbytes(g[0], g[2], *d)
    spline_pairs_ = B * (prep.n1 - prep.n_e) * prep.n2
    return {
        "fused_pair_fwd": (
            bound(common + nbytes(prep.mask_words, prep.coef,
                                  prep.tile_thresholds) + fwd_out + res,
                  live * OPS_PLANES + env_pairs * OPS_ENV_FWD),
            bound(common + nbytes(prep.mask, prep.coef) + fwd_out + dense,
                  spline_pairs_ * OPS_PLANES + env_pairs * OPS_ENV_FWD)),
        "fused_pair_bwd": (
            bound(common + nbytes(prep.mask_words) + res + bwd_io
                  + live_grid * g[1].element_size(),
                  live * OPS_PLANE_BWD + env_pairs * OPS_ENV_BWD),
            bound(common + nbytes(prep.mask, g[1]) + dense + bwd_io,
                  spline_pairs_ * OPS_PLANE_BWD + env_pairs * OPS_ENV_BWD)),
    }


def env_pair_count(prep, x):
    """Masked env pairs over the replicas of x."""
    return int(prep.mask[prep.r_e:prep.r_p].sum()) * x[0].shape[0]


def time_fused(dev, gen, base, path):
    import torch
    from upside_md_torch.ops.bp_pairs import (bp_bethe_pairs_fwd,
                                              scatter_pairs)
    from upside_md_torch.ops.fused_pair import fused_pair_bwd, fused_pair_fwd
    system, _ = load_system(path, dev, True)
    sys_p, _ = load_system(path, dev, False)
    n_t = TIME_REPLICAS
    pos = perturbed(base, n_t, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    o = fused_operands(system, outs, gen, dev)
    prep, x, st, E1 = o["prep"], o["x"], o["st"], o["E1"]
    fk = fused_pair_fwd(prep, *x)
    fpl = fused_pair_fwd(prep, *x, plain=True)
    g = [o["randn"](t) for t in fk[:3]]
    cold = bp_bethe_pairs_fwd(st, E1, fk[1])
    warm = (cold[3], cold[4])
    res = {}
    res["fused_pair_fwd"] = timed(
        lambda: fused_pair_fwd(prep, *x),
        lambda: fused_pair_fwd(prep, *x, plain=True))
    res["fused_pair_bwd"] = timed(
        lambda: fused_pair_bwd(prep, *x, fk[3], *g),
        lambda: fused_pair_bwd(prep, *x, fpl[3], *g, plain=True))
    del fpl
    out_bp = bp_bethe_pairs_fwd(st, E1, fk[1], warm)
    res["bp_bethe_pairs"] = timed(
        lambda: bp_bethe_pairs_fwd(st, E1, fk[1], warm),
        lambda: bp_bethe_pairs_fwd(st, E1, fk[1], warm, plain=True))

    # bounds from this run's inputs
    _, live, live_grid = fused_pairs(prep, x[0], x[2])
    kb = k1_bounds(prep, x, fk, g, fused_pair_bwd(prep, *x, fk[3], *g), live,
                   live_grid, env_pair_count(prep, x))
    bounds = {nm: b[0] for nm, b in kb.items()}
    before = {nm: b[1] for nm, b in kb.items()}
    eye = torch.eye(st.n_res, dtype=torch.bool, device=dev)
    adj = (scatter_pairs(st, fk[1]) != 0).any(-1).any(-1) & ~eye
    # K2 finds the adjacency in the bead grid, so it reads every pair of
    # the rotamer mask (upper triangle, different residues)
    r = st.bead_slot.long() // 6
    grid_pairs = int(torch.triu(r[:, None] != r[None, :], 1).sum()) * n_t
    bounds["bp_bethe_pairs"] = bp_bound(
        adj, warm, out_bp, grid_pairs * fk[1].element_size(), E1,
        st.slot_beads, st.bead_slot, st.valid)
    lat = {"bp_bethe_pairs": sweep_latency(
        lambda s: bp_bethe_pairs_fwd(s, E1, fk[1], warm), st, out_bp[6])}
    passes = {}
    for n in BP_TIME_REPLICAS:
        e1, ep = tiled(E1, n // n_t), tiled(fk[1], n // n_t)
        w = tuple(tiled(t, n // n_t) for t in warm)
        passes[n] = time_bp_passes(
            "bp_bethe_pairs", lambda: bp_bethe_pairs_fwd(st, e1, ep, w), n)
        del e1, ep, w
    del sys_p, outs, fk, o, x, g
    torch.cuda.empty_cache()
    rows = {}
    for n in ROW_TILE_REPLICAS:
        rows[n] = row_tile_k1(system, base, n, gen, dev)
    del system
    torch.cuda.empty_cache()
    return res, bounds, before, lat, {"bp_bethe_pairs": passes}, \
        {"fused_pair_fwd": {n: r["fwd"] for n, r in rows.items()},
         "fused_pair_bwd": {n: r["bwd"] for n, r in rows.items()},
         "fused_pair_bwd_recompute (env band)": {
             n: r["k3_env"] for n, r in rows.items()}}


def row_tile_k1(system, base, n, gen, dev):
    """K1's forward and backward at n replicas of perturbed ubiquitin (the
    operands from the kernels' own evaluation): `compare_k1` on the first
    COMPARE_REPLICAS (the kernel's cull and residual of all n; at 512
    replicas the kernels give a row tile one warp, at 64 four), each
    call's time split by launch, the residual's bytes, the bounds; and K3
    with the env band, the backward of `System(residuals=False)`, timed on
    the same cotangents."""
    import torch
    from upside_md_torch.ops.fused_pair import (fused_pair_bwd,
                                                fused_pair_bwd_recompute,
                                                fused_pair_fwd)
    pos = perturbed(base, n, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(pos)
        o = fused_operands(system, outs, gen, dev)
        prep, x = o["prep"], o["x"]
        err_f, err_b, cull, fk, g = compare_k1("ubiquitin", prep, x,
                                               o["randn"], COMPARE_REPLICAS)
        used, alloc, dense = residual_bytes(prep, fk[3])
        log(f"[resid] K1 ubiquitin at {n} replicas: the live pairs' residual "
            f"{used / 1e6:.4f} MB a replica against the dense planes' "
            f"{dense / 1e6:.4f} MB; allocated {alloc / 1e6:.4f} MB a replica, "
            f"{alloc * n / 1e9:.3f} GB in all (the planes: "
            f"{dense * n / 1e9:.3f} GB)")
        rec = {"fwd": time_launches("fused_pair_fwd (K1 fwd)",
                                    lambda: fused_pair_fwd(prep, *x), n),
               "bwd": time_launches(
                   "fused_pair_bwd (K1 bwd)",
                   lambda: fused_pair_bwd(prep, *x, fk[3], *g), n),
               "k3_env": time_launches(
                   "fused_pair_bwd_recompute (K3, env band)",
                   lambda: fused_pair_bwd_recompute(prep, *x, *g), n)}
        kb = k1_bounds(prep, x, fk, g, fused_pair_bwd(prep, *x, fk[3], *g),
                       cull["live_pairs"], cull["live_grid_pairs"],
                       env_pair_count(prep, x))
        for key, nm in (("fwd", "fused_pair_fwd"), ("bwd", "fused_pair_bwd")):
            rec[key].update(bound_ms=kb[nm][0], bound_table_ms=kb[nm][1],
                            max_abs_err=err_f if key == "fwd" else err_b,
                            resid_bytes_per_replica=used,
                            resid_alloc_bytes_per_replica=alloc,
                            dense_bytes_per_replica=dense)
            log_bounds(f"K1 {key}", n, rec[key])
        rec["fwd"]["cull"] = cull
    del outs, o, x, g, fk
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the fused block without its env band (no-env ubiquitin): K1 fwd, K3, K2
# ---------------------------------------------------------------------------

def compare_noenv(dev, gen, base, path):
    import torch
    from upside_md_torch.ops.bp_pairs import scatter_pairs
    from upside_md_torch.ops.fused_pair import fused_pair_fwd
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    if sys_k.pair_fusion is None or sys_k.pair_fusion.env is not None:
        raise AssertionError("no-env ubiquitin must fuse without the env "
                             "band")
    pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    o = fused_operands(sys_k, outs, gen, dev)
    prep, x = o["prep"], o["x"]
    log(f"[compare no-env ubiquitin] rows {prep.n1} (hbond {prep.r_b}, "
        f"hydrophobe {prep.r_e - prep.r_b}, env {prep.n_e}, beads "
        f"{prep.n2}) x {prep.n2} columns, {COMPARE_REPLICAS} replicas")
    fk = fused_pair_fwd(prep, *x, want_planes=False)
    repeatable("K1 fwd without planes", fk[:3],
               fused_pair_fwd(prep, *x, want_planes=False)[:3])
    fpl = fused_pair_fwd(prep, *x, plain=True, want_planes=False)
    torch.cuda.synchronize()
    if fk[3] is not None or fk[2].numel():
        raise AssertionError("K1 fwd without planes or env band wrote them")
    errs = {"fused_pair_fwd": compare(
        ["K1 fwd (no planes) cov", "K1 fwd (no planes) E_pair"], fk[:2],
        fpl[:2], 1e-5)}
    errs["fused_pair_bwd_recompute"] = compare_k3("no env band", prep, x,
                                                  fpl, o["randn"])
    errs["param_deriv"] = compare_param_deriv(
        path, dev, pos, "no-env ubiquitin",
        ("rotamer", "hbond_coverage", "hbond_coverage_hydrophobe"))
    st, E1, E_pair = o["st"], o["E1"], fpl[1]
    eye = torch.eye(st.n_res, dtype=torch.bool, device=dev)
    adj = (scatter_pairs(st, E_pair) != 0).any(-1).any(-1) & ~eye
    errs["bp_bethe_pairs"], counts = check_k2("K2 no env", st, E1, E_pair,
                                              adj)
    layout = log_layout("K2 no-env ubiquitin", counts, COMPARE_REPLICAS)
    whole = compare_whole(sys_k, sys_p, pos, "no-env ubiquitin")
    return errs, whole, layout


def time_noenv(dev, gen, base, path):
    """K3 and its plain version at TIME_REPLICAS, beside its bounds (the
    live pairs' and the table's of PRs 1-4, `k3_bounds`)."""
    import torch
    from upside_md_torch.ops.fused_pair import (fused_pair_bwd_recompute,
                                                fused_pair_fwd)
    system, _ = load_system(path, dev, True)
    sys_p, _ = load_system(path, dev, False)
    n_t = TIME_REPLICAS
    pos = perturbed(base, n_t, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    o = fused_operands(system, outs, gen, dev)
    prep, x = o["prep"], o["x"]
    fk = fused_pair_fwd(prep, *x, want_planes=False)
    g = [o["randn"](t) for t in fk[:3]]
    res = {"fused_pair_bwd_recompute": timed(
        lambda: fused_pair_bwd_recompute(prep, *x, *g),
        lambda: fused_pair_bwd_recompute(prep, *x, *g, plain=True))}
    masked, live, live_grid = fused_pairs(prep, x[0], x[2])
    d = fused_pair_bwd_recompute(prep, *x, *g)
    bounds, before = ({"fused_pair_bwd_recompute": b} for b in k3_bounds(
        prep, x, g, d, masked, live, live_grid))
    log(f"[time] no-env ubiquitin at {n_t} replicas: {masked} masked and "
        f"{live} live pairs ({live_grid} in the pair band)")
    del sys_p, outs, fk
    rows = {}
    for n in ROW_TILE_REPLICAS:
        rows[n] = row_tile_k3(system, base, n, gen, dev)
    del system
    torch.cuda.empty_cache()
    return res, bounds, before, {"fused_pair_bwd_recompute": rows}


def k3_bounds(prep, x, g, d, masked, live, live_grid):
    """K3's bound: the live pairs' work alone (the spline and its backward;
    a pair beyond the cutoff needs none, and the kernel's cull skips it),
    with each input read once (the packed mask the kernel reads, the grid
    cotangent only where a live pair reads it) and each output written
    once; and the bound as PRs 1-4 counted it, kept to compare with them:
    also the geometry of every masked pair, and the dense uint8 mask."""
    common = nbytes(*x, prep.row_type, prep.col_type, prep.coef, g[0], g[2],
                    *d) + live_grid * g[1].element_size()
    return (bound(common + nbytes(prep.mask_words), live * OPS_BWD),
            bound(common + nbytes(prep.mask),
                  masked * OPS_GEOM + live * (OPS_BWD - OPS_GEOM)))


def row_tile_k3(system, base, n, gen, dev):
    """K3 at n replicas of perturbed no-env ubiquitin (its operands from
    the kernels' own evaluation): its cull held to `cull_tiles`, its time
    split by launch, its bounds."""
    import torch
    from upside_md_torch.ops.fused_pair import (cull_tiles,
                                                fused_pair_bwd_recompute,
                                                fused_pair_fwd)
    pos = perturbed(base, n, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(pos)
        o = fused_operands(system, outs, gen, dev)
        prep, x = o["prep"], o["x"]
        g = [o["randn"](t)
             for t in fused_pair_fwd(prep, *x, want_planes=False)[:3]]
        keep = cull_tiles(prep, x[0], x[2])
        flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
        d = fused_pair_bwd_recompute(prep, *x, *g, flags=flags)
        masked, live, live_grid = fused_pairs(prep, x[0], x[2])
        rec = {"cull": check_cull(f"K3 no-env ubiquitin, {n} replicas",
                                  flags, keep, live, masked)}
        # the first replicas against the plain version: at 512 replicas
        # the kernel gives each row tile one warp, at 64 four
        first = slice(0, COMPARE_REPLICAS)
        rec["max_abs_err"] = compare(
            [f"K3 at {n} replicas, the first {COMPARE_REPLICAS}, d1",
             f"K3 at {n} replicas, the first {COMPARE_REPLICAS}, d2"],
            [t[first] for t in d], fused_pair_bwd_recompute(
                prep, *(t[first] for t in x), *(t[first] for t in g),
                plain=True), 1e-4)
        rec.update(time_launches(
            "fused_pair_bwd_recompute (K3)",
            lambda: fused_pair_bwd_recompute(prep, *x, *g), n))
        rec["bound_ms"], rec["bound_table_ms"] = k3_bounds(
            prep, x, g, d, masked, live, live_grid)
    log_bounds("K3", n, rec)
    del outs, o, x, g, d, keep, flags
    torch.cuda.empty_cache()
    return rec


def run_train(path, dev, gen, base):
    """fit_packed of the rotamer table under the energy-gap loss on
    TRAIN_CONFIGS perturbed configurations, TRAIN_STEPS Adam steps; the
    launch counts set to 0 just before and read just after."""
    import torch
    from upside_md_torch import training
    from upside_md_torch.ops import kernels
    from upside_md_torch.ops.fused_pair import table_cotangent
    system, _ = load_system(path, dev)
    pos = perturbed(base, TRAIN_CONFIGS, gen, dev)
    states = training.rotamer_node_marginals(system, pos[0]).argmax(-1)
    fixed = training.rotamer_state_restricted_system(system, states.cpu())

    stamps = []     # host clock at the start of each step's loss

    def loss_of_params(p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return training.energy_gap_loss(fixed, system, pos)(p, {})

    torch.cuda.synchronize()
    kernels.reset_counts()
    _, hist = training.fit_packed(system, loss_of_params, system.params,
                                  ["rotamer"], n_steps=TRAIN_STEPS,
                                  learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    per_step = statistics.median(steps[1:])
    launches = dict(kernels.LAUNCHES)
    log(f"[train] energy-gap loss over {TRAIN_STEPS} Adam steps "
        f"(lr {TRAIN_LR}, {TRAIN_CONFIGS} configurations): {hist}")
    log(f"[train] {per_step:.4f} s per step (median after the first; "
        f"steps {[round(s, 4) for s in steps]} s); kernel launches "
        f"{launches}")
    if not (all(math.isfinite(v) for v in hist) and hist[-1] < hist[0]):
        raise AssertionError(f"training loss not finite or not lower: {hist}")
    for nm in NOENV_KERNELS:
        if launches[nm] <= 0:
            raise AssertionError(f"kernel {nm} was not launched by training")

    # the rotamer table's cotangent (plain PyTorch): two per step, one for
    # each of the two systems
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(pos)
    plan, prep = system.pair_fusion, system.fused_prepared()
    x1, _, x2, _ = plan.block_inputs(system.consts, outs)
    table = system.params[plan.rot.name]["interaction_param"]
    A1, A2 = prep.type_rows
    g = torch.randn((TRAIN_CONFIGS, prep.n2, prep.n2), generator=gen,
                    device=dev)
    cot_ms = cuda_ms(lambda: table_cotangent(
        table, prep.row_type[prep.r_p:] - A1 - A2, prep.col_type[3],
        x1[:, prep.r_p:], x2, prep.mask[prep.r_p:], g), reps=5)
    share = 2 * cot_ms / 1e3 / per_step
    log(f"[train] rotamer table cotangent {cot_ms:.4f} ms per call, "
        f"{share:.3f} of a step")
    return {"loss": hist, "s_per_step": per_step, "step_s": steps,
            "table_cotangent_ms": cot_ms, "table_cotangent_share": share}, \
        {nm: launches[nm] for nm in NOENV_KERNELS}


# ---------------------------------------------------------------------------
# the unfused path (RNase A): K4, K5, K6
# ---------------------------------------------------------------------------

def unfused_operands(system, outs):
    """Each coverage node's (spline statics, table, rows, columns, weight)
    and the rotamer's beads, 1-body energies and statics."""
    from upside_md_torch.nodes.rotamer import assemble_one_body
    covs = []
    for s in system.specs:
        if s.node_type.name == "hbond_coverage":
            c = system.consts[s.name]
            rows = outs[s.args[0]][:, c["index1"]]
            cols = outs[s.args[1]][:, c["index2"]]
            covs.append((s.name, c["spline"],
                         system.params[s.name]["interaction_param"],
                         rows[..., :6].contiguous(),
                         cols[..., :6].contiguous(),
                         ((1.0 - rows[..., 6]) ** 2).contiguous()))
    rot = [s for s in system.specs if s.node_type.name == "rotamer"][0]
    c = system.consts[rot.name]
    beads = outs[rot.args[0]][:, c["index"], :6].contiguous()
    E1 = assemble_one_body(c, [outs[a] for a in rot.args])
    return covs, (c, system.params[rot.name], beads, E1)


def bp_planes_inputs(rot_ops, grid):
    """K6's operands (statics, Boltzmann planes, adjacency), as the
    rotamer node forms them."""
    from upside_md_torch.nodes.rotamer import residue_planes
    from upside_md_torch.ops.bp_planes import boltzmann_planes
    c, p, beads, _ = rot_ops
    st = c["bp"]
    E2planes, adj = residue_planes(c, p, beads, grid)
    return st, boltzmann_planes(E2planes, st.valid), adj


def compare_unfused(dev, gen, base, path):
    import torch
    from upside_md_torch.ops import quadspline as qs
    from upside_md_torch.ops.bp_planes import (bp_bethe_planes_fwd,
                                               bp_planes_kernel)
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    if sys_k.pair_fusion is not None:
        raise AssertionError("RNase A must take the unfused path")
    pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    covs, rot_ops = unfused_operands(sys_k, outs)
    c, p, beads, E1 = rot_ops
    log(f"[compare RNase A] coverage rows "
        f"{[cv[3].shape[1] for cv in covs]} x {beads.shape[1]} beads, "
        f"{c['bp'].n_res} residues, {COMPARE_REPLICAS} replicas")
    randn = (lambda t: torch.randn(t.shape, generator=gen, device=dev))
    errs = {}

    ps, tab = c["spline"], c["spline"].table(p["interaction_param"])
    keep = qs.cull_tiles(ps, tab, beads, beads)
    masked, live = spline_pairs(ps, tab, beads, beads)
    flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
    k5 = qs.quadspline_fwd(ps, tab, beads, beads, flags=flags)
    repeatable("K5 fwd", (k5,), (qs.quadspline_fwd(ps, tab, beads, beads),))
    check_cull(f"K5 fwd, {COMPARE_REPLICAS} replicas", flags, keep, live,
               masked)
    p5 = qs.quadspline_fwd(ps, tab, beads, beads, plain=True)
    errs["quadspline_fwd"] = compare_grid(
        "K5 fwd grid", k5, p5, qs.live_pairs(ps, tab, beads, beads))
    g5 = randn(k5)
    flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
    kb = qs.quadspline_bwd(ps, tab, beads, beads, g5, flags=flags)
    repeatable("K5 bwd", kb, qs.quadspline_bwd(ps, tab, beads, beads, g5))
    check_cull(f"K5 bwd, {COMPARE_REPLICAS} replicas", flags, keep, live,
               masked)
    errs["quadspline_bwd"] = compare(
        ["K5 bwd d1", "K5 bwd d2"], kb,
        qs.quadspline_bwd(ps, tab, beads, beads, g5, plain=True), 1e-4)
    dirty = g5.clone()
    dirty[~qs.live_pairs(ps, tab, beads, beads)] = float("nan")
    if not all(torch.isfinite(a).all() and a.equal(b) for a, b in zip(
            qs.quadspline_bwd(ps, tab, beads, beads, dirty), kb)):
        raise AssertionError("K5 bwd: NaN in dead slots of the grid "
                             "cotangent moved the result")
    log("  K5 bwd: bitwise repeatable; NaN in dead grid slots leaves it "
        "unchanged")

    errs["colsum_fwd"] = errs["colsum_bwd"] = 0.0
    for name, cps, table, x1, x2, w1 in covs:
        ctab = cps.table(table)
        keep = qs.cull_tiles(cps, ctab, x1, x2)
        masked, live = spline_pairs(cps, ctab, x1, x2)
        flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
        k4 = qs.colsum_fwd(cps, ctab, x1, x2, w1, flags=flags)
        repeatable("K4 fwd", (k4,), (qs.colsum_fwd(cps, ctab, x1, x2, w1),))
        check_cull(f"K4 fwd {name}, {COMPARE_REPLICAS} replicas", flags,
                   keep, live, masked)
        errs["colsum_fwd"] = max(errs["colsum_fwd"], compare(
            [f"K4 fwd {name}"], (k4,),
            (qs.colsum_fwd(cps, ctab, x1, x2, w1, plain=True),), 1e-5))
        g4 = randn(k4)
        flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
        kb = qs.colsum_bwd(cps, ctab, x1, x2, w1, g4, flags=flags)
        repeatable("K4 bwd", kb, qs.colsum_bwd(cps, ctab, x1, x2, w1, g4))
        check_cull(f"K4 bwd {name}, {COMPARE_REPLICAS} replicas", flags,
                   keep, live, masked)
        errs["colsum_bwd"] = max(errs["colsum_bwd"], compare(
            [f"K4 bwd {name} d1 (dw in col 6)", f"K4 bwd {name} d2"], kb,
            qs.colsum_bwd(cps, ctab, x1, x2, w1, g4, plain=True), 1e-4))

    st, P, adj = bp_planes_inputs(rot_ops, k5)
    worst = 0.0
    for tol in BP_COMPARE_TOLS:
        # warm: a perturbed problem from the cold solution
        s_ = dataclasses.replace(st, tol=tol)
        err, counts, _ = check_bp(
            f"K6 tol {tol:g}", lambda w, init: bp_planes_kernel(
                s_, E1 * (0.98 if w else 1.0), P, adj, init),
            lambda w, init: bp_bethe_planes_fwd(
                s_, E1 * (0.98 if w else 1.0), P, adj, init, plain=True),
            adj, False, equal_sweeps=tol >= BP_SWEEPS_TOL)
        worst = max(worst, err)
    errs["bp_bethe_planes"] = worst
    layout = log_layout("K6 RNase A", counts, COMPARE_REPLICAS)
    whole = compare_whole(sys_k, sys_p, pos, "RNase A")
    return errs, whole, layout


def time_unfused(dev, gen, base, path):
    import torch
    from upside_md_torch.ops import quadspline as qs
    from upside_md_torch.ops.bp_planes import bp_bethe_planes_fwd
    system, _ = load_system(path, dev, True)
    sys_p, _ = load_system(path, dev, False)
    n_t = TIME_REPLICAS
    pos = perturbed(base, n_t, gen, dev)
    with torch.no_grad():
        _, outs, _, _ = sys_p.evaluate(pos)
    covs, rot_ops = unfused_operands(system, outs)
    c, p, beads, E1 = rot_ops
    ps, tab = c["spline"], c["spline"].table(p["interaction_param"])
    randn = (lambda t: torch.randn(t.shape, generator=gen, device=dev))
    grid = qs.quadspline_fwd(ps, tab, beads, beads)
    g5 = randn(grid)
    cov_ops = [(cps, cps.table(table), x1, x2, w1)
               for _, cps, table, x1, x2, w1 in covs]
    g4 = [randn(x2[..., 0]) for _, _, _, x2, _ in cov_ops]
    st, P, adj = bp_planes_inputs(rot_ops, grid)
    cold = bp_bethe_planes_fwd(st, E1, P, adj)
    warm = (cold[3], cold[4])

    def k4_fwd(plain):
        return [qs.colsum_fwd(*o, plain=plain) for o in cov_ops]

    def k4_bwd(plain):
        return [qs.colsum_bwd(*o, g, plain=plain)
                for o, g in zip(cov_ops, g4)]

    res = {
        "quadspline_fwd": timed(
            lambda: qs.quadspline_fwd(ps, tab, beads, beads),
            lambda: qs.quadspline_fwd(ps, tab, beads, beads, plain=True)),
        "quadspline_bwd": timed(
            lambda: qs.quadspline_bwd(ps, tab, beads, beads, g5),
            lambda: qs.quadspline_bwd(ps, tab, beads, beads, g5,
                                      plain=True)),
        "colsum_fwd": timed(lambda: k4_fwd(False), lambda: k4_fwd(True)),
        "colsum_bwd": timed(lambda: k4_bwd(False), lambda: k4_bwd(True)),
        "bp_bethe_planes": timed(
            lambda: bp_bethe_planes_fwd(st, E1, P, adj, warm),
            lambda: bp_bethe_planes_fwd(st, E1, P, adj, warm, plain=True)),
    }

    with torch.no_grad():
        bounds, before = {}, {}
        pairs5 = spline_pairs(ps, tab, beads, beads)
        bounds["quadspline_fwd"], before["quadspline_fwd"] = k5_fwd_bounds(
            ps, tab, beads, grid, pairs5)
        bounds["quadspline_bwd"], before["quadspline_bwd"] = k5_bwd_bounds(
            ps, tab, beads, g5, qs.quadspline_bwd(ps, tab, beads, beads, g5),
            pairs5)
        pairs = [spline_pairs(*o[:4]) for o in cov_ops]
        bounds["colsum_fwd"], before["colsum_fwd"] = k4_fwd_bounds(
            cov_ops, [qs.colsum_fwd(*o) for o in cov_ops], pairs)
        calls = [(*o, g) for o, g in zip(cov_ops, g4)]
        bounds["colsum_bwd"], before["colsum_bwd"] = k4_bwd_bounds(
            calls, [qs.colsum_bwd(*c) for c in calls], pairs)
        out6 = bp_bethe_planes_fwd(st, E1, P, adj, warm)
        # 36 factors of each adjacent directed edge
        bounds["bp_bethe_planes"] = bp_bound(
            adj, warm, out6, int(adj.sum()) * 36 * P.element_size(), E1,
            adj, st.valid)
    lat = {"bp_bethe_planes": sweep_latency(
        lambda s: bp_bethe_planes_fwd(s, E1, P, adj, warm), st, out6[6])}
    del sys_p, outs, grid, out6, cold
    rows = {"quadspline_fwd": {}, "quadspline_bwd": {}, "colsum_fwd": {},
            "colsum_bwd": {}}
    for n in ROW_TILE_REPLICAS:
        pos = perturbed(base, n, gen, dev)
        with torch.no_grad():
            _, outs, _, _ = system.evaluate(pos)
            covs, rot_ops = unfused_operands(system, outs)
        del outs
        for nm, rec in row_tile_k4(covs, n, gen, dev).items():
            rows[nm][n] = rec
        for nm, rec in row_tile_k5(rot_ops, n, gen, dev).items():
            rows[nm][n] = rec
        del covs, rot_ops
        torch.cuda.empty_cache()
    del system
    passes = {}
    for n in BP_TIME_REPLICAS:
        e1, pl, ad = (tiled(t, n // n_t) for t in (E1, P, adj))
        w = tuple(tiled(t, n // n_t) for t in warm)
        passes[n] = time_bp_passes(
            "bp_bethe_planes", lambda: bp_bethe_planes_fwd(st, e1, pl, ad, w),
            n)
        del e1, pl, ad, w
    del P
    torch.cuda.empty_cache()
    return res, bounds, before, lat, {"bp_bethe_planes": passes}, rows


def spline_bounds(parts):
    """The bounds of a row-tile spline kernel over its calls, `parts`
    [(bytes of its inputs but the mask and of its outputs, spline statics,
    masked pairs, live pairs, operations a live pair)]: the live pairs'
    work alone, with each input read once (the packed mask words the
    kernel reads) and each output written once; and the bound as the dense
    designs counted it, kept to compare with them: also the geometry of
    every masked pair, and the dense uint8 mask."""
    n_live = n_table = ops_live = ops_table = 0
    for n_bytes, sp, masked, live, per_live in parts:
        n_live += n_bytes + nbytes(sp.mask_words)
        n_table += n_bytes + nbytes(sp.mask)
        ops_live += live * per_live
        ops_table += masked * OPS_GEOM + live * (per_live - OPS_GEOM)
    return bound(n_live, ops_live), bound(n_table, ops_table)


def k4_bwd_bounds(calls, outs, pairs):
    """K4 backward's bounds (`spline_bounds`) over its calls [(spline
    statics, table, x1, x2, w1, g)] with outputs `outs` and (masked, live)
    pairs `pairs`."""
    return spline_bounds(
        (nbytes(x1, x2, w1, g, cps.t1, cps.t2, cps.tile_alive, ctab.coef,
                *d), cps, masked, live, OPS_BWD + 5)
        for (cps, ctab, x1, x2, w1, g), d, (masked, live)
        in zip(calls, outs, pairs))


def k4_fwd_bounds(calls, outs, pairs):
    """K4 forward's bounds (`spline_bounds`) over its calls [(spline
    statics, table, x1, x2, w1)] with outputs `outs` and (masked, live)
    pairs `pairs`: a live pair's value, its weight's multiply and add."""
    return spline_bounds(
        (nbytes(x1, x2, w1, cps.t1, cps.t2, cps.tile_alive, ctab.coef, out),
         cps, masked, live, OPS_VALUE + 2)
        for (cps, ctab, x1, x2, w1), out, (masked, live)
        in zip(calls, outs, pairs))


def k5_fwd_bounds(ps, tab, beads, out, pairs):
    """K5 forward's bounds (`spline_bounds`) for the bead set `beads`
    (read once: rows and columns are the same sites), the grid `out`
    written once and (masked, live) pairs `pairs`: a live pair's value."""
    masked, live = pairs
    return spline_bounds([(
        nbytes(beads, ps.t1, ps.t2, ps.tile_alive, tab.coef, out), ps,
        masked, live, OPS_VALUE)])


def k5_bwd_bounds(ps, tab, beads, g, d, pairs):
    """K5 backward's bounds (`spline_bounds`) for the bead set `beads`
    (read once: rows and columns are the same sites), the grid cotangent g
    of which only the live pairs' entries are read, the outputs d and
    (masked, live) pairs `pairs`."""
    masked, live = pairs
    return spline_bounds([(
        nbytes(beads, ps.t1, ps.t2, ps.tile_alive, tab.coef, *d)
        + live * g.element_size(), ps, masked, live, OPS_BWD)])


def log_bounds(label, n, rec):
    log(f"[time] {label} at {n} replicas: bound of the live pairs "
        f"{rec['bound_ms'][0]:.4f} ms ({rec['bound_ms'][1]}), as counted "
        f"before {rec['bound_table_ms'][0]:.4f} ms "
        f"({rec['bound_table_ms'][1]})")


def row_tile_k4(covs, n, gen, dev, where="RNase A"):
    """K4's forward and backward, both coverage calls of one evaluation, at
    n replicas of perturbed `where` (`covs`: the operands from the
    kernels' own evaluation): each call's cull held to `cull_tiles`, the
    first COMPARE_REPLICAS against the plain versions, bitwise repeatable,
    each kernel's time split by launch, its bounds (`k4_fwd_bounds`,
    `k4_bwd_bounds`)."""
    import torch
    from upside_md_torch.ops import quadspline as qs
    first = slice(0, COMPARE_REPLICAS)
    with torch.no_grad():
        calls, outs_f, outs_b, pairs = [], [], [], []
        fwd, bwd = {"cull": {}}, {"cull": {}}
        for name, cps, table, x1, x2, w1 in covs:
            ctab = cps.table(table)
            g = torch.randn(x2[..., 0].shape, generator=gen, device=dev)
            keep = qs.cull_tiles(cps, ctab, x1, x2)
            masked, live = spline_pairs(cps, ctab, x1, x2)
            for label, rec, run, plain, outs, tol in (
                    ("K4 fwd", fwd,
                     lambda **kw: (qs.colsum_fwd(cps, ctab, x1, x2, w1,
                                                 **kw),),
                     lambda: (qs.colsum_fwd(cps, ctab, x1[first], x2[first],
                                            w1[first], plain=True),),
                     outs_f, 1e-5),
                    ("K4 bwd", bwd,
                     lambda **kw: qs.colsum_bwd(cps, ctab, x1, x2, w1, g,
                                                **kw),
                     lambda: qs.colsum_bwd(cps, ctab, x1[first], x2[first],
                                           w1[first], g[first], plain=True),
                     outs_b, 1e-4)):
                flags = torch.full(keep.shape, 7, dtype=torch.uint8,
                                   device=dev)
                d = run(flags=flags)
                repeatable(f"{label} {name} at {n} replicas", d, run())
                rec["cull"][name] = check_cull(
                    f"{label} {name}, {where}, {n} replicas", flags, keep,
                    live, masked)
                compare([f"{label} {name} at {n} replicas, the first "
                         f"{COMPARE_REPLICAS}, output {k}"
                         for k in range(len(d))],
                        [t[first] for t in d], plain(), tol)
                outs.append(d[0] if label == "K4 fwd" else d)
            calls.append((cps, ctab, x1, x2, w1, g))
            pairs.append((masked, live))
        fwd.update(time_launches(
            f"colsum_fwd (K4 fwd, both calls, {where})",
            lambda: [qs.colsum_fwd(*c[:5]) for c in calls], n))
        fwd["bound_ms"], fwd["bound_table_ms"] = k4_fwd_bounds(
            [c[:5] for c in calls], outs_f, pairs)
        bwd.update(time_launches(
            f"colsum_bwd (K4 bwd, both calls, {where})",
            lambda: [qs.colsum_bwd(*c) for c in calls], n))
        bwd["bound_ms"], bwd["bound_table_ms"] = k4_bwd_bounds(calls, outs_b,
                                                               pairs)
    log_bounds(f"K4 fwd, {where},", n, fwd)
    log_bounds(f"K4 bwd, {where},", n, bwd)
    del calls, outs_f, outs_b
    torch.cuda.empty_cache()
    return {"colsum_fwd": fwd, "colsum_bwd": bwd}


def row_tile_k5(rot_ops, n, gen, dev, where="RNase A"):
    """K5's forward, and its backward under a random grid cotangent, at n
    replicas of perturbed `where` (`rot_ops`: the rotamer beads of the
    kernels' own evaluation): each one's cull held to `cull_tiles`, the
    first COMPARE_REPLICAS against the plain version (the forward exactly
    0 where the plain one has no live pair), bitwise repeatable, its time
    split by launch, its bounds (`k5_fwd_bounds`, `k5_bwd_bounds`); beside
    the forward the device time of a `zero_` of its grid, the time its
    bytes alone take."""
    import torch
    from upside_md_torch.ops import quadspline as qs
    c, p, beads, _ = rot_ops
    ps = c["spline"]
    tab = ps.table(p["interaction_param"])
    first = slice(0, COMPARE_REPLICAS)
    with torch.no_grad():
        g = torch.randn((n, ps.n1, ps.n2), generator=gen, device=dev)
        keep = qs.cull_tiles(ps, tab, beads, beads)
        flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
        d = qs.quadspline_bwd(ps, tab, beads, beads, g, flags=flags)
        repeatable(f"K5 bwd at {n} replicas", d,
                   qs.quadspline_bwd(ps, tab, beads, beads, g))
        masked, live = spline_pairs(ps, tab, beads, beads)
        rec = {"cull": check_cull(f"K5 bwd, {where}, {n} replicas", flags,
                                  keep, live, masked)}
        flags = torch.full(keep.shape, 7, dtype=torch.uint8, device=dev)
        out = qs.quadspline_fwd(ps, tab, beads, beads, flags=flags)
        repeatable(f"K5 fwd at {n} replicas", (out,),
                   (qs.quadspline_fwd(ps, tab, beads, beads),))
        fwd = {"cull": check_cull(f"K5 fwd, {where}, {n} replicas", flags,
                                  keep, live, masked)}
        compare_grid(f"K5 fwd at {n} replicas, the first "
                     f"{COMPARE_REPLICAS}", out[first], qs.quadspline_fwd(
                         ps, tab, beads[first], beads[first], plain=True),
                     qs.live_pairs(ps, tab, beads[first], beads[first]))
        fwd.update(time_launches(
            f"quadspline_fwd (K5 fwd, {where})",
            lambda: qs.quadspline_fwd(ps, tab, beads, beads), n))
        fwd["grid_zero_device_ms"] = time_launches(
            "zero_ of K5 fwd's grid (its bytes alone)", out.zero_,
            n)["device_ms"]
        fwd["bound_ms"], fwd["bound_table_ms"] = k5_fwd_bounds(
            ps, tab, beads, out, (masked, live))
        # the triangle's load by row tile: tiles walked and live pairs, a
        # replica
        live_rt = torch.nn.functional.pad(
            qs.live_pairs(ps, tab, beads, beads).sum((0, 2)),
            (0, -ps.n1 % 32)).reshape(-1, 32).sum(1)
        rec["walked_by_row_tile"] = (keep.sum((0, 2)) / n).tolist()
        rec["live_by_row_tile"] = (live_rt / n).tolist()
        log(f"[balance] K5 bwd, {where}, at {n} replicas, a replica by row "
            "tile: "
            f"tiles walked {[round(v, 2) for v in rec['walked_by_row_tile']]}"
            f", live pairs {[round(v, 1) for v in rec['live_by_row_tile']]}")
        compare([f"K5 bwd at {n} replicas, the first {COMPARE_REPLICAS}, "
                 f"d{k}" for k in (1, 2)], [t[first] for t in d],
                qs.quadspline_bwd(ps, tab, beads[first], beads[first],
                                  g[first], plain=True), 1e-4)
        rec.update(time_launches(
            f"quadspline_bwd (K5 bwd, {where})",
            lambda: qs.quadspline_bwd(ps, tab, beads, beads, g), n))
        rec["bound_ms"], rec["bound_table_ms"] = k5_bwd_bounds(
            ps, tab, beads, g, d, (masked, live))
    log_bounds(f"K5 fwd, {where},", n, fwd)
    log_bounds(f"K5 bwd, {where},", n, rec)
    del g, d, out
    torch.cuda.empty_cache()
    return {"quadspline_fwd": fwd, "quadspline_bwd": rec}


# ---------------------------------------------------------------------------
# the BP cases the bundles do not reach
# ---------------------------------------------------------------------------

def compare_bp_cases(dev):
    """K2 and K6 against their plain versions on the synthetic cases of
    ops/bp_cases.py (three beads in a rotamer slot, 128 residues, enough
    edges for each layout of the solve, mixed batches: replicas that stop
    after different sweep counts, one without any edge, a residue without
    a neighbour, invalid slots), cold and warm on the problem with E1
    scaled by WARM_SCALE, at the cases' BP tol with equal sweep counts and
    at TIGHT_TOL for the values.  Returns the max abs error of each
    kernel."""
    import torch
    from upside_md_torch.ops import bp_cases as bc
    from upside_md_torch.ops import bp_pairs as bp
    from upside_md_torch.ops import bp_planes as bpp
    f32 = dict(dtype=torch.float32, device=dev)
    tols = ((bc.BP_SETTINGS[2], True), (bc.TIGHT_TOL, False))

    def scale(w):
        return bc.WARM_SCALE if w else 1.0

    def check_case(kernel, name, run, plain, st, adj, shared):
        worst = 0.0
        for tol, equal_sweeps in tols:
            s_ = dataclasses.replace(st, tol=tol)
            err, counts, iters = check_bp(
                f"{kernel} ({name}) tol {tol:g}",
                lambda w, init: run(s_, w, init),
                lambda w, init: plain(s_, w, init), adj, shared,
                equal_sweeps)
            worst = max(worst, err)
            if equal_sweeps and len(set(iters)) < 2:
                raise AssertionError(f"case {name}: the replicas did not "
                                     f"stop at different sweep counts "
                                     f"({iters})")
            if counts[:, 2].max().item() != bc.CASE_LAYOUT.get(name, 0):
                raise AssertionError(f"case {name}: layouts "
                                     f"{counts[:, 2].tolist()}")
        return worst

    errs = {"bp_bethe_pairs": 0.0, "bp_bethe_planes": 0.0}
    for name, kw in bc.PAIRS_CASES.items():
        E1, E, res, rot, valid, n2p = bc.pairs_case(**bc.MIXED, **kw)
        st = bp.make_statics(res, rot, valid, n2p, *bc.BP_SETTINGS, dev)
        if st.slot_beads.shape[1] != kw["m_slot"]:
            raise AssertionError(f"case {name}: wrong beads per slot")
        e1, ep = torch.tensor(E1, **f32), torch.tensor(E, **f32)
        eye = torch.eye(st.n_res, dtype=torch.bool, device=dev)
        adj = (bp.scatter_pairs(st, ep) != 0).any(-1).any(-1) & ~eye
        log(f"[compare K2 case: {name}] {st.n_res} residues, {st.n_bead} "
            f"beads, {st.slot_beads.shape[1]} beads a slot, edges "
            f"{adj.sum((1, 2)).tolist()}")
        errs["bp_bethe_pairs"] = max(errs["bp_bethe_pairs"], check_case(
            "K2", name,
            lambda s_, w, init: bp.bp_pairs_kernel(s_, scale(w) * e1, ep,
                                                   init),
            lambda s_, w, init: bp.bp_bethe_pairs_fwd(s_, scale(w) * e1, ep,
                                                      init, plain=True),
            st, adj, True))
    for name, kw in bc.PLANES_CASES.items():
        E1, E2, adj, res, rot, valid = bc.planes_case(**bc.MIXED, **kw)
        st = bp.make_statics(res, rot, valid, 128, *bc.BP_SETTINGS, dev)
        e1, e2 = torch.tensor(E1, **f32), torch.tensor(E2, **f32)
        a = torch.tensor(adj, device=dev)
        P = bpp.boltzmann_planes(e2, st.valid)
        log(f"[compare K6 case: {name}] edges {a.sum((1, 2)).tolist()}")
        errs["bp_bethe_planes"] = max(errs["bp_bethe_planes"], check_case(
            "K6", name,
            lambda s_, w, init: bpp.bp_planes_kernel(s_, scale(w) * e1, P, a,
                                                     init),
            lambda s_, w, init: bpp.bp_bethe_planes_fwd(
                s_, scale(w) * e1, P, a, init, plain=True),
            st, a, False))
    return errs


# ---------------------------------------------------------------------------
# shared phases
# ---------------------------------------------------------------------------

def compare_whole(sys_k, sys_p, pos, label, params_k=None, params_p=None):
    import torch
    gk, ek, _ = sys_k.deriv(pos, sys_k.init_cache(pos.shape[0]), None,
                            params_k)
    gp, ep, _ = sys_p.deriv(pos, sys_p.init_cache(pos.shape[0]), None,
                            params_p)
    err_e = ((ek - ep).abs() / ep.abs().clamp(min=1.0)).max().item()
    err_g = ((gk - gp).pow(2).mean().sqrt()
             / gp.pow(2).mean().sqrt().clamp(min=1e-12)).item()
    check(f"{label} whole evaluation energy", err_e, 1e-3)
    check(f"{label} whole evaluation force RMS", err_g, 1e-3)
    if not (torch.isfinite(gk).all() and torch.isfinite(ek).all()):
        raise AssertionError(f"{label}: non-finite energy or forces")
    return {"energy_rel": err_e, "force_rms_rel": err_g}


def md_rate(system, pos0, n_rep, rounds):
    """steps/s of `rounds` rounds after 2 warm-up rounds (median of 3
    blocks), the mean BP sweeps a force evaluation of the last block, and
    the final state."""
    import torch
    from upside_md_torch.md.sim import Simulation
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=1)
    state = sim.advance(sim.initial_state(pos0, n_rep, temperature=0.85), 2)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s0, e0 = state.bp_sweeps.sum().item(), state.n_evals
        t0 = time.perf_counter()
        state = sim.advance(state, rounds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sweeps = (state.bp_sweeps.sum().item() - s0) / (
        (state.n_evals - e0) * n_rep)
    if not torch.isfinite(state.pos).all():
        raise AssertionError(f"MD at {n_rep} replicas: positions not "
                             "finite")
    return 3 * rounds * n_rep / statistics.median(times), times, sweeps, \
        state


def run_md(path, dev, label, names, rounds=5, absent=(), max_sweeps=None):
    """MD on one path at 64 and 512 replicas; the launch counts are set to 0
    just before and read just after, each of `names` must be > 0 and each
    of `absent` 0; the mean BP sweeps per evaluation (two decimals) must
    not exceed `max_sweeps`."""
    import torch
    from upside_md_torch.ops import kernels
    system, pos0 = load_system(path, dev)
    md = {}
    kernels.reset_counts()
    for n_rep in MD_REPLICAS:
        torch.cuda.reset_peak_memory_stats()
        rate, times, sweeps, state = md_rate(system, pos0, n_rep, rounds)
        if state.pos.shape != (n_rep,) + tuple(pos0.shape):
            raise AssertionError(f"{label} MD at {n_rep} replicas: bad "
                                 "positions")
        if max_sweeps is not None and round(sweeps, 2) > max_sweeps:
            raise AssertionError(f"{label} MD at {n_rep} replicas: mean BP "
                                 f"sweeps {sweeps:.4f} above {max_sweeps}")
        md[n_rep] = {"steps_per_s": rate, "times_s": times,
                     "mean_bp_sweeps": sweeps,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[md {label}] {n_rep} replicas: {rate:.1f} steps/s (median of "
            f"{[round(t, 4) for t in times]} s per {rounds} rounds), mean "
            f"BP sweeps {sweeps:.2f}, peak memory "
            f"{md[n_rep]['peak_mem_gb']:.2f} GB, positions finite")
        del state
        torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    log(f"[md {label}] kernel launches: {launches}")
    for nm in names:
        if launches[nm] <= 0:
            raise AssertionError(f"kernel {nm} was not launched by the "
                                 f"{label} MD")
    for nm in absent:
        if launches[nm] != 0:
            raise AssertionError(f"kernel {nm} was launched by the {label} "
                                 "MD")
    evals = launches["bp_bethe_pairs"] if "bp_bethe_pairs" in names \
        else launches["bp_bethe_planes"]
    log(f"[md {label}] launches per evaluation: "
        f"{ {nm: launches[nm] / evals for nm in names} }")
    return md, {nm: launches[nm] for nm in names}


# ---------------------------------------------------------------------------
# the replica-exchange path: BASELINE config 4 on cytochrome c
# ---------------------------------------------------------------------------

def ladder(system, n, nodes=None):
    """(params, spec) of n slots: the first spring node's spring_const
    (and each of `nodes`' interaction_param) scaled by 1 + 0.02 (i / (n -
    1) - 0.5) in slot i, the +-1% ladder of tools/bench_all.py:121-131,
    combined by `stack_param_ensembles`."""
    from upside_md_torch.md.sim import stack_param_ensembles
    vary = [(k, "spring_const") for k in system.params
            if "spring" in k and "spring_const" in system.params[k]][:1]
    vary += [(k, "interaction_param") for k in nodes or ()]
    slots = []
    for i in range(n):
        f = 1.0 + 0.02 * (i / max(n - 1, 1) - 0.5)
        p = {k: dict(v) for k, v in system.params.items()}
        for node, leaf in vary:
            p[node][leaf] = system.params[node][leaf] * f
        slots.append(p)
    return stack_param_ensembles(slots)


def compare_rex(dev, gen, base, path):
    """The gate at 4 replicas under the stacked spring ladder: the whole
    evaluation with kernels against `kernels=False` at BP tol 1e-6 (energy
    and force RMS rel < 1e-3); each slot's energy under the stacked
    parameters against `System.energy` under that slot's own (rel 1e-5),
    with the ladder alone (one K1 launch for all slots) and with the
    rotamer pair table stacked too (one K1 launch a slot)."""
    import torch
    from upside_md_torch.ops import kernels
    from upside_md_torch.system import slot_params
    n = COMPARE_REPLICAS
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    pos = perturbed(base, n, gen, dev)
    mixed, spec = ladder(sys_k, n)
    log(f"[compare rex cytochrome_c] {n} replicas, stacked leaves "
        f"{sorted(spec)}")
    out = compare_whole(sys_k, sys_p, pos, "cytochrome c spring ladder",
                        mixed, ladder(sys_p, n)[0])
    for label, nodes, k1 in (("spring ladder", (), 1),
                             ("spring ladder + rotamer table",
                              ("rotamer",), n)):
        mixed, spec = ladder(sys_k, n, nodes)
        with torch.no_grad():
            kernels.reset_counts()
            e = sys_k.energy(pos, mixed)
            launched = kernels.LAUNCHES["fused_pair_fwd"]
            alone = torch.cat([sys_k.energy(pos[i:i + 1],
                                            slot_params(mixed, spec, i))
                               for i in range(n)])
        if launched != k1:
            raise AssertionError(f"{label}: {launched} K1 launches, "
                                 f"expected {k1}")
        err = ((e - alone).abs() / alone.abs()).max().item()
        check(f"cytochrome c {label}: per-slot energies against each "
              f"slot alone ({launched} K1 launches)", err, 1e-5)
        out[label] = err
    return out


def rex_run(path, dev, mc):
    """BASELINE config 4 through `run_ensemble`: 64 replicas under the
    spring ladder at temperatures 0.80 1.02^i, even/odd swap sets every 10
    rounds, frames every 10 rounds, dt 0.009, thermostat interval 0.135;
    two warm-up exchange blocks, then 60 timed rounds with the launch
    counts set to 0 just before and read just after.  With `mc`, pivot
    moves every 10 rounds (the bundle's tables) and recentering at every
    frame.  Checks: replica_index a permutation, the last exchange's
    energies equal to a fresh `potential_energy` (rel 1e-6), positions
    and momenta finite, K1 fwd, K1 bwd and K2 launched; with `mc` a
    rejected pivot leaves its replica bitwise unchanged and the centres of
    mass are below 1e-4 A after the run's last recentering."""
    import numpy as np
    import torch
    from upside_md_torch.cli import run_ensemble
    from upside_md_torch.config import bundle
    from upside_md_torch.md.mc import PivotSampler, metropolis_step
    from upside_md_torch.md.replica import (ReplicaExchange,
                                            even_odd_swap_sets)
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.ops import kernels
    label = "rex cytochrome_c" + (" + pivot MC" if mc else "")
    n = REX_REPLICAS
    system, pos0 = load_system(path, dev)
    mixed, spec = ladder(system, n)
    interval = REX_EVERY * 3 * 0.009
    pm = bundle.load_aux(path)["pivot_moves"]
    pivot = PivotSampler.from_tables(
        pm["pivot_atom"], pm["pivot_range"], pm["pivot_restype"],
        pm["proposal_pot"], device=dev) if mc else None
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     frame_interval=interval,
                     mc_interval=interval if mc else None,
                     pivot_sampler=pivot, do_recenter=mc, seed=4)
    rex = ReplicaExchange(even_odd_swap_sets(n), n)
    state = sim.initial_state(pos0, n, 0.80 * 1.02 ** np.arange(n))
    warm = REX_WARMUP_BLOCKS * REX_EVERY
    state, _ = run_ensemble(sim, state, mixed, spec, warm, rex, REX_EVERY)
    s0, e0 = state.bp_sweeps.sum().item(), state.n_evals
    p0 = state.pivot_stats.sum(0).cpu()
    kernels.reset_counts()
    state, out = run_ensemble(sim, state, mixed, spec, warm + REX_ROUNDS,
                              rex, REX_EVERY)
    launches = dict(kernels.LAUNCHES)
    force_evals = state.n_evals - e0
    pivots = state.pivot_stats.sum(0).cpu() - p0
    # energy-only evaluations: frames, exchanges and two a Metropolis step
    energy_evals = out["n_energy_evals"] + 2 * pivots[1].item() // n
    evals = force_evals + energy_evals
    rate = 3 * REX_ROUNDS * n / out["seconds"]
    stats = torch.cat(out["rex_stats"]).sum(0).cpu()
    swap_acc = stats[0].item() / stats[1].item()
    sweeps = (state.bp_sweeps.sum().item() - s0) / (force_evals * n)
    ridx = out["replica_index"]
    if sorted(ridx.tolist()) != list(range(n)):
        raise AssertionError(f"{label}: replica_index {ridx.tolist()} is "
                             "not a permutation")
    fresh = sim.potential_energy(state, mixed)
    err = ((out["energies"] - fresh).abs() / fresh.abs()).max().item()
    check(f"{label}: energies carried by the last exchange against a "
          "fresh evaluation", err, 1e-6)
    if state.pos.device != torch.device(dev):
        raise AssertionError(f"{label}: the state left {dev}")
    if not (torch.isfinite(state.pos).all()
            and torch.isfinite(state.mom).all()):
        raise AssertionError(f"{label}: positions or momenta not finite")
    for nm in FUSED_KERNELS:
        if launches[nm] <= 0:
            raise AssertionError(f"kernel {nm} was not launched by the "
                                 f"{label} run")
    per_eval = {nm: launches[nm] / evals for nm in FUSED_KERNELS}
    res = {"steps_per_s": rate, "seconds": out["seconds"],
           "swap_acceptance": swap_acc, "swaps": stats.tolist(),
           "mean_bp_sweeps": sweeps, "force_evals": force_evals,
           "energy_evals": energy_evals, "launches": launches,
           "launches_per_eval": per_eval, "carried_energy_rel": err}
    log(f"[{label}] {n} replicas, {REX_ROUNDS} rounds: {rate:.1f} steps/s "
        f"with the swaps ({out['seconds']:.3f} s), swap acceptance "
        f"{swap_acc:.4f} ({stats[0].item()} of {stats[1].item()}), mean BP "
        f"sweeps {sweeps:.2f} a force evaluation, replica_index a "
        "permutation")
    log(f"[{label}] evaluations: {force_evals} with forces, "
        f"{energy_evals} energy only; launches {launches}; per "
        f"evaluation {per_eval}")
    if mc:
        ps = pivots
        res["pivot_acceptance"] = ps[0].item() / ps[1].item()
        com = state.pos.mean(1).abs().max().item()
        log(f"[{label}] pivot acceptance {res['pivot_acceptance']:.4f} "
            f"({ps[0].item()} of {ps[1].item()}), centre of mass after "
            f"the last recentering {com:.3e} A")
        if not com < 1e-4:
            raise AssertionError(f"{label}: centre of mass {com} A")
        res["com_after_recenter"] = com
        rejected = 0
        for _ in range(3):
            new, acc = metropolis_step(state.pos, state.temperature,
                                       sim.energy_fn(mixed), pivot,
                                       sim.generator)
            if not torch.equal(new[~acc], state.pos[~acc]):
                raise AssertionError(f"{label}: a rejected pivot moved "
                                     "its replica")
            rejected += int((~acc).sum())
            if rejected:
                break
        if not rejected:
            raise AssertionError(f"{label}: no pivot rejected in 3 steps")
        log(f"[{label}] {rejected} rejected pivots left their replicas "
            "bitwise unchanged")
        res["rejected_pivots_checked"] = rejected
    return res, {nm: launches[nm] for nm in FUSED_KERNELS}


# ---------------------------------------------------------------------------
# proteins past 128 residues and 1,024 beads: T4 lysozyme and GFP
# ---------------------------------------------------------------------------

def large_statics(system, label, n_res, n_bead):
    """The rotamer statics, checked against the bundle's size; the path
    must be the unfused one."""
    st = system.consts[[s.name for s in system.specs
                         if s.node_type.name == "rotamer"][0]]["bp"]
    if (st.n_res, st.n_bead) != (n_res, n_bead) \
            or system.pair_fusion is not None:
        raise AssertionError(f"{label}: {st.n_res} residues, {st.n_bead} "
                             "beads, or a fusion plan")
    return st


def read_launches(label, names):
    """The launch counts since they were set to 0: each of `names` must
    be > 0 and every other kernel 0."""
    from upside_md_torch.ops import kernels
    launches = dict(kernels.LAUNCHES)
    log(f"[{label}] kernel launches: {launches}")
    for nm, k in launches.items():
        if (k > 0) != (nm in names):
            raise AssertionError(f"{label}: kernel {nm} launched {k} times")
    return {nm: launches[nm] for nm in names}


def large_t4(dev, gen, base, path):
    """[large t4_lysozyme]: the whole evaluation with kernels against
    `kernels=False` at BP tol 1e-6; K4's and K5's forward and backward at
    64 replicas against their plain versions (phase 4's tolerances), their
    tile decisions equal to `cull_tiles`, device time by launch, bounds,
    and the plain versions' time at the same shapes."""
    import torch
    from upside_md_torch.ops import kernels
    from upside_md_torch.ops import quadspline as qs
    label = "large t4_lysozyme"
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    st = large_statics(sys_k, label, *T4_SIZE)
    log(f"[{label}] {st.n_res} residues, {st.n_bead} beads: K4, K5 and "
        "the plain BP solve")
    kernels.reset_counts()
    gate = compare_whole(sys_k, sys_p,
                         perturbed(base, COMPARE_REPLICAS, gen, dev),
                         f"[{label}]")
    read_launches(f"{label} gate", LARGE_KERNELS)
    del sys_p
    n = TIME_REPLICAS
    with torch.no_grad():
        _, outs, _, _ = sys_k.evaluate(perturbed(base, n, gen, dev))
        covs, rot_ops = unfused_operands(sys_k, outs)
    del outs
    rows = {**row_tile_k4(covs, n, gen, dev, "T4 lysozyme"),
            **row_tile_k5(rot_ops, n, gen, dev, "T4 lysozyme")}
    c, p, beads, _ = rot_ops
    ps = c["spline"]
    tab = ps.table(p["interaction_param"])
    g5 = torch.randn((n, ps.n1, ps.n2), generator=gen, device=dev)
    cov_ops = [(cps, cps.table(table), x1, x2, w1)
               for _, cps, table, x1, x2, w1 in covs]
    g4 = [torch.randn(x2[..., 0].shape, generator=gen, device=dev)
          for _, _, _, x2, _ in cov_ops]
    with torch.no_grad():
        plain = {
            "quadspline_fwd": lambda: qs.quadspline_fwd(ps, tab, beads, beads,
                                                        plain=True),
            "quadspline_bwd": lambda: qs.quadspline_bwd(ps, tab, beads, beads,
                                                        g5, plain=True),
            "colsum_fwd": lambda: [qs.colsum_fwd(*o, plain=True)
                                   for o in cov_ops],
            "colsum_bwd": lambda: [qs.colsum_bwd(*o, g, plain=True)
                                   for o, g in zip(cov_ops, g4)]}
        for nm, fn in plain.items():
            rows[nm]["plain_ms"] = cuda_ms(fn, reps=5)
            r = rows[nm]
            log(f"[{label}] {nm} at {n} replicas: {r['ms']:.4f} ms a call, "
                f"device {r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                f"ms, bound {r['bound_ms'][0]:.4f} ms ({r['bound_ms'][1]})")
    del covs, rot_ops, cov_ops, g4, g5, sys_k
    torch.cuda.empty_cache()
    return {"gate": gate, "kernels": rows}


def large_md(path, dev, label, replicas, names, rounds):
    """MD of a large protein at each replica count: 2 warm-up rounds, then
    3 x `rounds` timed rounds (steps/s, mean BP sweeps and host syncs of
    the plain solve a force evaluation, peak memory), then
    LARGE_PROFILE_ROUNDS rounds under `torch.profiler` with the plain BP
    solve (`bp_bethe_planes_plain`: `bp_solve_plain` and
    `bethe_and_gradients`) inside a range of its own: device time an
    evaluation, the idle share, the plain solve's share of device time
    and kernel launches an evaluation.  The launch counts are set to 0
    just before and read just after: each of `names` > 0, every other 0.
    Returns (records, launches, the last run's positions)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.ops import bp_pairs, kernels
    from upside_md_torch.ops import bp_planes as bpp
    system, pos0 = load_system(path, dev)
    md = {}
    kernels.reset_counts()
    for n_rep in replicas:
        torch.cuda.reset_peak_memory_stats()
        sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=1)
        state = sim.advance(sim.initial_state(pos0, n_rep, temperature=0.85),
                            2)
        torch.cuda.synchronize()
        times = []
        s0, e0 = state.bp_sweeps.sum().item(), state.n_evals
        h0 = bp_pairs.HOST_SYNCS["bp_solve_plain"]
        for _ in range(3):
            t0 = time.perf_counter()
            state = sim.advance(state, rounds)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        evals = state.n_evals - e0
        sweeps = (state.bp_sweeps.sum().item() - s0) / (evals * n_rep)
        syncs = (bp_pairs.HOST_SYNCS["bp_solve_plain"] - h0) / evals
        if not (state.pos.shape == (n_rep,) + tuple(pos0.shape)
                and torch.isfinite(state.pos).all()):
            raise AssertionError(f"{label} MD at {n_rep} replicas: bad "
                                 "positions")
        rate = 3 * rounds * n_rep / statistics.median(times)
        rec = {"steps_per_s": rate, "times_s": times,
               "mean_bp_sweeps": sweeps, "host_syncs_per_eval": syncs,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        real = bpp.bp_bethe_planes_plain

        def annotated(*args):
            with record_function("bp_solve_plain"):
                return real(*args)

        bpp.bp_bethe_planes_plain = annotated
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state = sim.advance(state, LARGE_PROFILE_ROUNDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            bpp.bp_bethe_planes_plain = real
        # the range's device-side copy is not device work
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != "bp_solve_plain"]
        busy = sum(e.device_time for e in kern) * 1e-6
        solve = sum(e.device_time_total for e in prof.events()
                    if e.name == "bp_solve_plain"
                    and e.device_type == torch.autograd.DeviceType.CPU) * 1e-6
        n_ev = 3 * LARGE_PROFILE_ROUNDS
        rec.update({"profiled_wall_s": wall, "device_s_per_eval": busy / n_ev,
                    "idle_share": 1.0 - busy / wall,
                    "plain_bp_share": solve / busy if busy else None,
                    "launches_per_eval": len(kern) / n_ev})
        share = "not measured" if not solve else \
            f"{rec['plain_bp_share']:.3f}"
        log(f"[{label}] MD {n_rep} replicas: {rate:.1f} steps/s (median of "
            f"{[round(t, 4) for t in times]} s per {rounds} rounds), mean BP "
            f"sweeps {sweeps:.2f}, host syncs of the plain solve {syncs:.2f} "
            f"an evaluation, peak memory {rec['peak_mem_gb']:.2f} GB; under "
            f"the profiler ({LARGE_PROFILE_ROUNDS} rounds, wall {wall:.4f} s)"
            f" device {rec['device_s_per_eval'] * 1e3:.3f} ms an evaluation, "
            f"idle share {rec['idle_share']:.3f}, plain BP solve's share of "
            f"device time {share}, {rec['launches_per_eval']:.0f} launches "
            "an evaluation; positions finite")
        md[n_rep] = rec
        last = state.pos
        del sim, state, prof, kern
        torch.cuda.empty_cache()
    launches = read_launches(f"{label} MD", names)
    return md, launches, last


def card_vs_host(label, sys_d, sys_h, pos, n_deriv_evals=0, gate=True):
    """A whole evaluation on the card against the port on the CPU (in the
    host system's dtype) at the same positions: energy rel and force RMS
    rel, checked < 1e-3 when `gate`, else only printed.  Returns the
    errors and both evaluations' per-term energies and outputs."""
    import torch
    n = pos.shape[0]
    gd, ed, _ = sys_d.deriv(pos, sys_d.init_cache(n),
                            n_deriv_evals=n_deriv_evals)
    x = pos.to(device="cpu", dtype=sys_h.dtype)
    gh, eh, _ = sys_h.deriv(x, sys_h.init_cache(n),
                            n_deriv_evals=n_deriv_evals)
    gd, ed = gd.double().cpu(), ed.double().cpu()
    gh, eh = gh.double(), eh.double()
    err_e = ((ed - eh).abs() / eh.abs().clamp(min=1.0)).max().item()
    err_g = ((gd - gh).pow(2).mean().sqrt()
             / gh.pow(2).mean().sqrt().clamp(min=1e-12)).item()
    what = f"card float32 against host {str(sys_h.dtype)[6:]}"
    if gate:
        check(f"[{label}] whole evaluation energy, {what}", err_e, 1e-3)
        check(f"[{label}] whole evaluation force RMS, {what}", err_g, 1e-3)
    else:
        log(f"  [{label}] whole evaluation, {what} (a measurement, not a "
            f"gate): energy rel {err_e:.3e}, force RMS rel {err_g:.3e}")
    if not (torch.isfinite(gd).all() and torch.isfinite(ed).all()):
        raise AssertionError(f"{label}: non-finite energy or forces")
    with torch.no_grad():
        _, outs_d, per_d, _ = sys_d.evaluate(pos, n_deriv_evals=n_deriv_evals)
        _, outs_h, per_h, _ = sys_h.evaluate(x, n_deriv_evals=n_deriv_evals)
    return ({"energy_rel": err_e, "force_rms_rel": err_g},
            (per_d, outs_d), (per_h, outs_h))


def large_gfp_gate(dev, gen, base, path):
    """[large gfp]: a whole evaluation on the card in float32 against the
    port on the CPU in float64, both at BP tol 1e-6: no kernel lies on
    this path, so the gate is device against host (energy and force RMS
    rel < 1e-3), and no kernel may launch.  Beside it, the same against
    the CPU in float32 (printed, not gated): precision apart from fault."""
    from upside_md_torch.ops import kernels
    label = "large gfp"
    sys_d, _ = load_system(path, dev, True, tol=1e-6)
    large_statics(sys_d, label, *GFP_SIZE)
    pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
    kernels.reset_counts()
    out = card_vs_host(label, sys_d, host_system(path, "float64"), pos)[0]
    read_launches(f"{label} gate", ())
    f32 = card_vs_host(label, sys_d, host_system(path, "float32"), pos,
                       gate=False)[0]
    log(f"[{label}] force RMS rel, card float32 against host float64 "
        f"{out['force_rms_rel']:.3e}, against host float32 "
        f"{f32['force_rms_rel']:.3e}")
    out["host_float32"] = f32
    return out


def large_nl(path, dev, pos, device_ms_per_eval):
    """[large gfp] NL: at `pos`, for the rotamer grid and both coverage
    nodes, the largest in-cutoff partner count of any row beside the
    list's width K, and the rows above K (whose farthest partners the list
    drops, as the reference's does); then the device time of the three
    neighbour-list calls of an evaluation, forward and backward under
    random cotangents, beside the MD's device time an evaluation."""
    import torch
    from upside_md_torch.nodes import hbond, rotamer
    from upside_md_torch.ops.pairs import partner_counts, quadspline_family
    system, _ = load_system(path, dev)
    with torch.no_grad():
        _, outs, _, _ = system.evaluate(pos)
    covs, (c, p, beads, _) = unfused_operands(system, outs)
    del outs
    sites = [(name, cps.mask, table, x1, x2, hbond.COVERAGE_NEIGHBOR_K)
             for name, cps, table, x1, x2, _ in covs]
    sites.append(("rotamer", c["spline"].mask, p["interaction_param"],
                  beads, beads, min(beads.shape[1], rotamer.NEIGHBOR_K)))
    out = {}
    for name, mask, table, x1, x2, K in sites:
        ka, k, dx = quadspline_family(table.shape[-1])
        cnt = partner_counts(x1[..., :3], x2[..., :3],
                             ((k - 2 - 1e-6) * dx) ** 2, mask.bool())
        out[name] = {"max_partners": int(cnt.max()), "K": K,
                     "rows_over_K": int((cnt > K).sum()), "rows": cnt.numel()}
        log(f"[large gfp] NL {name}: largest in-cutoff partner count of a "
            f"row {out[name]['max_partners']} beside K {K}; rows above K "
            f"{out[name]['rows_over_K']} of {cnt.numel()} ({pos.shape[0]} "
            "replicas)")
    gen = torch.Generator(device=dev).manual_seed(11)
    leaves = [t.detach().requires_grad_(True)
              for t in [beads] + [x for cv in covs for x in cv[3:5]]]

    def nl_calls():
        grid, _ = rotamer.assemble_pair_grid(c, p, leaves[0])
        parts = [grid] + [hbond.coverage_nl(system.consts[name], table,
                                            leaves[1 + 2 * i],
                                            leaves[2 + 2 * i], w1)
                          for i, (name, _, table, _, _, w1)
                          in enumerate(covs)]
        cots = [torch.randn(t.shape, generator=gen, device=dev)
                for t in parts]
        torch.autograd.grad(sum((t * g).sum() for t, g in zip(parts, cots)),
                            leaves)

    ms = device_ms(nl_calls, reps=5)
    share = None if ms is None else ms / device_ms_per_eval
    out["device_ms"], out["share_of_md_device_time"] = ms, share
    log(f"[large gfp] NL: the three neighbour-list calls of an evaluation, "
        f"forward and backward, device "
        f"{'not measured' if ms is None else f'{ms:.3f} ms'} at "
        f"{pos.shape[0]} replicas; "
        f"{'not measured' if share is None else f'{share:.3f}'} of the MD's "
        f"device time an evaluation ({device_ms_per_eval:.3f} ms)")
    del covs, leaves, system
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# the remaining node types: config 2, chi1 prediction, the extras
# ---------------------------------------------------------------------------

def plan_names(system):
    """(cov1, cov2, rot, env) of a system's fusion plan, or None."""
    f = system.pair_fusion
    return None if f is None else (f.cov1.name, f.cov2.name, f.rot.name,
                                   None if f.env is None else f.env.name)


def profiled_round(path, dev, n_rep, ranges=(), specs=None):
    """PROFILE_ROUNDS rounds of MD under `torch.profiler` after 2 warm-up
    rounds, each node type named in `ranges` inside a `record_function`
    range of its name (its forward: autograd runs the backward outside
    it): device time an evaluation, idle share, device launches an
    evaluation and each range's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.nodes.base import NODE_REGISTRY
    from upside_md_torch.system import System
    if specs is None:
        system, pos0 = load_system(path, dev)
    else:
        system = System(len(specs[1]), specs[0], dev, torch.float32)
        pos0 = specs[1]
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135, seed=1)
    state = sim.advance(sim.initial_state(pos0, n_rep, temperature=0.85), 2)
    torch.cuda.synchronize()
    real = {nm: NODE_REGISTRY[nm].compute for nm in ranges}

    def ranged(nm, fn):
        def compute(*args):
            with record_function(nm):
                return fn(*args)
        return compute

    for nm, fn in real.items():
        NODE_REGISTRY[nm].compute = ranged(nm, fn)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state = sim.advance(state, PROFILE_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for nm, fn in real.items():
            NODE_REGISTRY[nm].compute = fn
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in real]
    busy = sum(e.device_time for e in kern) * 1e-6
    if not busy:
        raise AssertionError("the profiler recorded no device time")
    n_ev = 3 * PROFILE_ROUNDS
    shares = {nm: sum(e.device_time_total for e in prof.events()
                      if e.name == nm and e.device_type
                      == torch.autograd.DeviceType.CPU) * 1e-6 / busy
              for nm in real}
    return {"wall_s": wall, "device_ms_per_eval": busy / n_ev * 1e3,
            "idle_share": 1.0 - busy / wall,
            "launches_per_eval": len(kern) / n_ev,
            "range_share_fwd": shares}


def node_call(system, pos, name, gen):
    """A node's forward and backward (under a random cotangent) at the
    inputs the graph gives it at `pos`: (device ms, device launches) of
    one call."""
    import torch
    from upside_md_torch.system import EvalContext
    with torch.no_grad():
        outs = system.evaluate(pos, n_deriv_evals=1)[1]
    spec = system.by_name[name]
    ins = [outs[a].detach().requires_grad_(True) for a in spec.args]
    ctx = EvalContext(n_replica=pos.shape[0], n_deriv_evals=1)
    ctx.node_name = name
    out = spec.node_type.compute(system.consts[name], system.params[name],
                                 ins, ctx)
    cot = torch.randn(out.shape, generator=gen, device=pos.device)

    def call():
        o = spec.node_type.compute(system.consts[name], system.params[name],
                                   ins, ctx)
        torch.autograd.grad((o * cot).sum(), ins)
    return device_ms(call, reps=5), len(device_events(call, reps=1))


def config2(dev, gen, path, ubq_path):
    """[config2 ubiquitin_radial]: BASELINE config 2 (the ubiquitin full
    force field with sidechain_radial packing).  The fusion plan's node
    names equal ubiquitin_full_synth's; the whole evaluation with kernels
    against `kernels=False` at BP tol 1e-6 and on the card against the
    port on the CPU in float64 (energy and force RMS rel < 1e-3), K1 fwd,
    K1 bwd and K2 launched once by its one force evaluation and nothing
    else; MD at 64 and 512 replicas (`run_md`: steps/s, mean BP sweeps <=
    CONFIG2_MAX_SWEEPS, launches per evaluation; ubiquitin_full_synth's
    steps/s and sweeps under the same schedule beside them); then one
    profiled round at each count
    beside ubiquitin_full_synth's: device time and launches an
    evaluation, idle share, `radial`'s share (its forward's range, and its
    forward and backward timed apart over the device time an
    evaluation)."""
    import torch
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels
    label = "config2 ubiquitin_radial"
    sys_k, _ = load_system(path, dev, True, tol=1e-6)
    sys_p, _ = load_system(path, dev, False, tol=1e-6)
    plan, plan_u = plan_names(sys_k), plan_names(load_system(ubq_path,
                                                             dev)[0])
    log(f"[{label}] fusion plan {plan}; ubiquitin_full_synth's {plan_u}")
    if plan is None or plan != plan_u or plan[3] is None:
        raise AssertionError(f"{label}: fusion plan {plan}, ubiquitin's "
                             f"{plan_u}")
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
    kernels.reset_counts()
    out = {"gate": compare_whole(sys_k, sys_p, pos, f"[{label}]")}
    got = read_launches(f"{label} gate", FUSED_KERNELS)
    if any(k != 1 for k in got.values()):
        raise AssertionError(f"{label}: {got} launches for one force "
                             "evaluation")
    out["host"] = card_vs_host(label, sys_k, host_system(path, "float64"),
                               pos)[0]
    del sys_p
    out["md"], launches = run_md(path, dev, label, FUSED_KERNELS, rounds=3,
                                 max_sweeps=CONFIG2_MAX_SWEEPS)
    ubq, pos_u = load_system(ubq_path, dev)
    for n_rep, r in out["md"].items():
        rate_u, _, sweeps_u, _ = md_rate(ubq, pos_u, n_rep, 3)
        r["ubiquitin_full"] = {"steps_per_s": rate_u,
                               "mean_bp_sweeps": sweeps_u}
        log(f"[{label}] MD {n_rep} replicas: {r['steps_per_s']:.1f} steps/s"
            f", mean BP sweeps {r['mean_bp_sweeps']:.4f}; ubiquitin_full_"
            f"synth under the same schedule {rate_u:.1f} steps/s, mean BP "
            f"sweeps {sweeps_u:.4f}")
    del ubq
    evals = launches["bp_bethe_pairs"]
    per_eval = {nm: k / evals for nm, k in launches.items()}
    log(f"[{label}] kernel launches per force evaluation {per_eval}")
    if any(v != 1.0 for v in per_eval.values()):
        raise AssertionError(f"{label}: launches per evaluation {per_eval}")
    out["profile"] = {}
    for n_rep in MD_REPLICAS:
        pr = profiled_round(path, dev, n_rep, ("radial",))
        pu = profiled_round(ubq_path, dev, n_rep)
        ms, n_launch = node_call(sys_k, perturbed(base, n_rep, gen, dev),
                                 "radial", gen)
        pr["radial_fwd_bwd_ms"], pr["radial_launches"] = ms, n_launch
        pr["radial_share"] = None if ms is None \
            else ms / pr["device_ms_per_eval"]
        out["profile"][n_rep] = {"config2": pr, "ubiquitin_full": pu}
        share = "not measured" if ms is None else \
            f"{pr['radial_share']:.4f} ({ms:.4f} ms, {n_launch} launches)"
        log(f"[{label}] profiled round at {n_rep} replicas: device "
            f"{pr['device_ms_per_eval']:.3f} ms an evaluation (ubiquitin_full"
            f"_synth {pu['device_ms_per_eval']:.3f}), idle share "
            f"{pr['idle_share']:.3f} ({pu['idle_share']:.3f}), "
            f"{pr['launches_per_eval']:.0f} device launches an evaluation "
            f"({pu['launches_per_eval']:.0f}); radial's share of device time:"
            f" its forward's range {pr['range_share_fwd']['radial']:.4f}, "
            f"forward and backward timed apart {share}")
    del sys_k
    torch.cuda.empty_cache()
    return out, launches


def chi1_phase(dev, gen, path):
    """[chi1 ubiquitin]: BASELINE config 5.  `predict_chi1_from_bundle` on
    the card at 1 and 64 configurations, the launch counts set to 0 just
    before and read just after: K1 fwd and K2 launched (twice a
    prediction: `get_sens` evaluates once for the output's shape and once
    for its cotangent, as the JAX package's does), K1 bwd not (the
    sensitivities need no cotangent of the positions, so no backward of
    the fused block runs: K3 is reported); its wall time and the
    evaluation's.  The gate, card float32 against the port on the CPU in
    float64 at the same configurations, takes BP tol 1e-6 (float32
    rounding of the deviation decides when the solve at the bundle's 1e-3
    stops): probabilities' largest absolute difference < 1e-3, every row
    summing to 1 within 2e-2; the difference at the bundle's tol is
    printed beside it."""
    import torch
    from upside_md_torch.chi1 import Chi1Predict, predict_chi1_from_bundle
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels
    label = "chi1 ubiquitin"
    base = torch.as_tensor(bundle.load(path)[1], device=dev)
    aux = bundle.load_aux(path)["chi1"]
    pred = Chi1Predict.from_aux(aux)
    seq = [str(s) for s in aux["sequence"]]
    sys_d, _ = load_system(path, dev, True, tol=1e-6)
    sys_h = host_system(path, "float64")
    residue = sys_h.consts["placement_fixed_point_vector_only"][
        "affine_residue"].numpy()
    out, launches = {}, {nm: 0 for nm in kernels.KERNELS}
    predict_chi1_from_bundle(path, dev, base)          # warm-up
    for n in CHI1_CONFIGS:
        pos = perturbed(base, n, gen, dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        prob, seq_d, elapsed = predict_chi1_from_bundle(path, dev, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        for nm, k in got.items():
            launches[nm] += k
        log(f"[{label}] {n} configurations: kernel launches {got}")
        for nm in ("fused_pair_fwd", "bp_bethe_pairs"):
            if got[nm] <= 0:
                raise AssertionError(f"{label}: {nm} not launched")
        if got["fused_pair_bwd"] != 0:
            raise AssertionError(f"{label}: K1's backward launched")
        prob_h32 = pred.predict_chi1(
            seq, residue, sys_h.get_sens(pos.double().cpu(),
                                         "hbond_coverage")[..., 0])
        real_tol = (prob.cpu() - prob_h32).abs().max().item()
        prob_d = pred.predict_chi1(
            seq, residue, sys_d.get_sens(pos, "hbond_coverage")[..., 0])
        err = (prob_d.cpu() - prob_h32).abs().max().item()
        rows = (prob.sum(-1) - 1.0).abs().max().item()
        log(f"  [{label}] {n} configurations, BP tol 1e-6: chi1 "
            f"probabilities' largest absolute difference card float32 "
            f"against host float64 {err:.3e} (tol 1e-3; at the bundle's "
            f"BP tol 1e-3 {real_tol:.3e}); rows sum to 1 within {rows:.3e} "
            "(tol 2e-2)")
        if not err < 1e-3:
            raise AssertionError(f"{label}: chi1 probabilities differ by "
                                 f"{err}")
        if not rows < 2e-2 or seq_d != seq or tuple(prob.shape) != \
                (n, len(seq), 3) or not torch.isfinite(prob).all():
            raise AssertionError(f"{label}: bad probabilities")
        out[n] = {"max_abs_diff": err, "max_abs_diff_bundle_tol": real_tol,
                  "row_sum_err": rows, "evaluation_s": elapsed,
                  "wall_s": wall, "launches": got}
        log(f"[{label}] {n} configurations: one prediction "
            f"{wall * 1e3:.1f} ms wall (bundle load and System included), "
            f"the evaluation (get_sens) {elapsed * 1e3:.1f} ms; K3 launched "
            f"{got['fused_pair_bwd_recompute']} times")
    del sys_d, sys_h
    torch.cuda.empty_cache()
    return out, {nm: k for nm, k in launches.items() if k}


def extras_phase(dev, gen, path):
    """[extras trp_cage]: trp_cage_extras_synth (every builder extra,
    `dynamic_1body=False`) and the hand-built graph on it
    (`config/extras_graph.py`), on the card in float32 against the port on
    the CPU in float64 at BP tol 1e-6 and the force-evaluation counter 7:
    the whole evaluation's energy and force RMS rel < 1e-3, each of the 24
    node types' energy or output with its error, the fusion plan with the
    env band, K1 fwd, K1 bwd and K2 launched once by the force evaluation.
    Then MD_ROUNDS_EXTRAS rounds of MD of the hand-built graph at 64
    replicas (launch counts set to 0 just before, read just after), AFM's
    energy after them against a CPU evaluation at the same counter (rel <
    1e-5), steps/s; one profiled round (device time and launches an
    evaluation, idle share, the forward ranges of radial and fixed_hmm);
    radial's and fixed_hmm's forward and backward timed apart, with their
    device launches (fixed_hmm's forward recursion runs a few launches a
    residue)."""
    import torch
    from upside_md_torch.config import bundle
    from upside_md_torch.config.extras_graph import EXTRAS_NODES, extras_graph
    from upside_md_torch.ops import kernels
    from upside_md_torch.system import System
    label = "extras trp_cage"
    recs, pos0 = bundle.load(path)
    base = torch.as_tensor(pos0, device=dev)
    graphs = {"bundle": lambda: bundle.load(path)[0],
              "hand_built": lambda: extras_graph(*bundle.load(path))}
    out = {}
    for graph, make in graphs.items():
        specs = make()
        for s in specs:
            if s.type_name == "rotamer":
                s.consts["tol"] = 1e-6
        sys_d = System(len(pos0), specs, dev, torch.float32)
        plan = plan_names(sys_d)
        if plan != ("hbond_coverage", "hbond_coverage_hydrophobe",
                    "rotamer", "environment_coverage"):
            raise AssertionError(f"{label} {graph}: fusion plan {plan}")
        pos = perturbed(base, COMPARE_REPLICAS, gen, dev)
        kernels.reset_counts()
        sys_d.deriv(pos, sys_d.init_cache(COMPARE_REPLICAS),
                    n_deriv_evals=N_DERIV_EVALS)
        got = read_launches(f"{label} {graph} gate", FUSED_KERNELS)
        if any(k != 1 for k in got.values()):
            raise AssertionError(f"{label}: {got} launches for one force "
                                 "evaluation")
        errs, (per_d, outs_d), (per_h, outs_h) = card_vs_host(
            f"{label} {graph}", sys_d,
            host_system(path, "float64", specs=make()), pos, N_DERIV_EVALS)
        nodes = {}
        for t, nm in EXTRAS_NODES.items():
            if nm not in sys_d.by_name:
                continue
            if nm in per_d:
                d, h = per_d[nm].double().cpu(), per_h[nm]
                what = f"energy {d[0].item():.6g} (host {h[0].item():.6g})"
            else:
                d, h = outs_d[nm].double().cpu(), outs_h[nm]
                what = f"output {tuple(d.shape)}"
            e = ((d - h).abs().max() / h.abs().max().clamp(min=1e-12)).item()
            nodes[t] = e
            log(f"  [{label}] {graph} {t} ({nm}): {what}, rel err {e:.3e}")
            if not e < 1e-3:
                raise AssertionError(f"{label} {graph}: {nm} rel err {e}")
        out[graph] = {**errs, "nodes": nodes}
        del sys_d
    if set(out["hand_built"]["nodes"]) != set(EXTRAS_NODES):
        raise AssertionError(f"{label}: the graphs miss node types")

    # MD of the hand-built graph
    specs = extras_graph(*bundle.load(path))
    system = System(len(pos0), specs, dev, torch.float32)
    kernels.reset_counts()
    rate, times, sweeps, state = md_rate(system, pos0, EXTRAS_REPLICAS,
                                         MD_ROUNDS_EXTRAS)
    launches = read_launches(f"{label} MD", FUSED_KERNELS)
    evals = launches["bp_bethe_pairs"]
    counter = 3 * state.round_num
    host = host_system(path, "float64", specs=extras_graph(
        *bundle.load(path)))
    with torch.no_grad():
        afm_d = system.evaluate(state.pos,
                                n_deriv_evals=counter)[2]["AFM"].double()
        afm_h = host.evaluate(state.pos.double().cpu(),
                              n_deriv_evals=counter)[2]["AFM"]
        afm_0 = host.evaluate(state.pos.double().cpu())[2]["AFM"]
    afm_err = ((afm_d.cpu() - afm_h).abs() / afm_h.abs()).max().item()
    check(f"[{label}] AFM energy after {state.round_num} rounds at the "
          f"counter {counter}, card against host", afm_err, 1e-5)
    if not (afm_h - afm_0).abs().min() > 0:
        raise AssertionError(f"{label}: the AFM tip did not move")
    log(f"[{label}] MD {EXTRAS_REPLICAS} replicas: {rate:.1f} steps/s "
        f"(median of {[round(t, 4) for t in times]} s per {MD_ROUNDS_EXTRAS}"
        f" rounds), mean BP sweeps {sweeps:.2f}; kernel launches per force "
        f"evaluation { {nm: k / evals for nm, k in launches.items()} }; AFM "
        f"energy {afm_h.mean().item():.4f} at the counter {counter} "
        f"(counter 0: {afm_0.mean().item():.4f})")
    prof = profiled_round(None, dev, EXTRAS_REPLICAS,
                          ("radial", "fixed_hmm"), (specs, pos0))
    calls = {}
    for nm in ("radial", "fixed_hmm"):
        ms, n_launch = node_call(system, state.pos, nm, gen)
        calls[nm] = {"fwd_bwd_ms": ms, "launches": n_launch,
                     "share": None if ms is None
                     else ms / prof["device_ms_per_eval"]}
        share = "not measured" if ms is None else \
            f"{calls[nm]['share']:.4f} ({ms:.4f} ms)"
        log(f"[{label}] {nm}: forward range {prof['range_share_fwd'][nm]:.4f}"
            f" of device time, forward and backward timed apart {share}, "
            f"{n_launch} device launches an evaluation")
    log(f"[{label}] profiled round at {EXTRAS_REPLICAS} replicas: device "
        f"{prof['device_ms_per_eval']:.3f} ms an evaluation, idle share "
        f"{prof['idle_share']:.3f}, {prof['launches_per_eval']:.0f} device "
        "launches an evaluation")
    out["md"] = {"steps_per_s": rate, "times_s": times,
                 "mean_bp_sweeps": sweeps, "afm_rel": afm_err,
                 "profile": prof, "nodes": calls}
    del system, state, host
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# the command line and its trajectory files
# ---------------------------------------------------------------------------

class _Recorded:
    """`cli.main`'s loop, frames and loggers, recorded: `cli.run_ensemble`,
    `cli._frame` and `cli.H5Logger` wrapped for the duration of a `with`
    block, so a run hands back its final state, summary, loggers and each
    frame's values; the wall time of each frame (the evaluation with its
    streams, the copies to the host and the frame callback's logging, from
    a synchronised card); and the clock at each `run_ensemble` call's start
    and end and at each logger's close, its files written."""

    def __enter__(self):
        import torch
        from upside_md_torch import cli
        self.cli, self.runs, self.loggers, self.frame_s = cli, [], [], []
        self.values, self.run_t, self.close_t = [], [], []
        self.saved = cli.run_ensemble, cli._frame, cli.H5Logger
        run, frame, logger_cls = self.saved
        runs, loggers, frame_s = self.runs, self.loggers, self.frame_s
        values, run_t, close_t = self.values, self.run_t, self.close_t

        def sync():
            if torch.cuda.is_available():
                torch.cuda.synchronize()

        def run_ensemble(*a, **k):
            cb = k.get("frame_callback")
            if cb is not None:
                def timed_cb(done, v):
                    t0 = time.perf_counter()
                    cb(done, v)
                    frame_s[-1] += time.perf_counter() - t0
                    values.append((done, v))
                k["frame_callback"] = timed_cb
            t0 = time.perf_counter()
            out = run(*a, **k)
            run_t.append((t0, time.perf_counter()))
            runs.append(out)
            return out

        def timed_frame(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = frame(*a, **k)
            frame_s.append(time.perf_counter() - t0)
            return out

        class Logger(logger_cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                loggers.append(self)

            def close(self):
                super().close()
                close_t.append(time.perf_counter())

        cli.run_ensemble, cli._frame, cli.H5Logger = \
            run_ensemble, timed_frame, Logger
        return self

    def __exit__(self, *exc):
        self.cli.run_ensemble, self.cli._frame, self.cli.H5Logger = \
            self.saved


def cli_flags(rounds, every, temps, out):
    return [f"--duration={rounds * 3 * 0.009}",
            f"--frame-interval={every * 3 * 0.009}",
            f"--temperature={','.join(f'{t:.6f}' for t in temps)}",
            "--thermostat-interval=0.135", "--log-level=detailed",
            f"--output-dir={out}", "--device=cuda"]


def read_frames(paths):
    """{dataset: (n_slot, n_frame, ...)} of /output in each slot's file,
    read with the port's reader; every value finite."""
    import numpy as np
    from upside_md_torch.io import h5
    out = {}
    for path in paths:
        with h5.File(path) as f:
            for k, ds in f["output"].items():
                a = ds[()]
                if a.dtype.kind == "f" and not np.isfinite(a).all():
                    raise AssertionError(f"{path}: output/{k} not finite")
                out.setdefault(k, []).append(a)
    return {k: np.stack(v) for k, v in out.items()}


def replay_appends(cli, values, tmp, n, frame_bytes):
    """The append path on this host: CLI_APPEND_FRAMES frames, `values`
    (a run's recorded (round, frame values)) taken in turn, logged through
    `cli.log_values` into n fresh slot files, as `cli.main` logs them.
    Every BUFFER_FRAMES frames each logger flushes: the first flush
    creates the datasets, the later ones append BUFFER_FRAMES rows to
    them.  For each flush: its ms a slot (the logger's own clock of its
    writes) and the files' growth, which must be the new rows' chunks
    (BUFFER_FRAMES frames of frame_bytes) and no more than 8 bytes of
    padding a dataset, never a copy of earlier data.  The files are read
    back with the port's reader: every frame, each position as logged."""
    import numpy as np
    from upside_md_torch.io import h5
    from upside_md_torch.io.logger import BUFFER_FRAMES, H5Logger
    label = "cli append"
    d = os.path.join(tmp, "append")
    os.makedirs(d)
    paths = [os.path.join(d, f"slot_{i}.h5") for i in range(n)]
    loggers = [H5Logger(p, input_pos=values[0][1]["pos"][i])
               for i, p in enumerate(paths)]
    size = [os.path.getsize(p) for p in paths]
    flushes, buffer_s = [], []
    for k in range(CLI_APPEND_FRAMES):
        v = values[k % len(values)][1]
        seen = [len(lg.flush_seconds) for lg in loggers]
        t0 = time.perf_counter()
        cli.log_values(loggers, 3 * 0.009 * (k + 1), v)
        wall = time.perf_counter() - t0
        if (k + 1) % BUFFER_FRAMES:
            buffer_s.append(wall)
            continue
        ms = [1e3 * sum(lg.flush_seconds[j:]) for lg, j in zip(loggers, seen)]
        n_ds = len(loggers[0].flush_seconds) - seen[0]  # one write each
        new = [os.path.getsize(p) for p in paths]
        grow = [b - a for a, b in zip(size, new)]
        size = new
        data = BUFFER_FRAMES * frame_bytes
        if flushes and not all(data <= g <= data + 8 * n_ds for g in grow):
            raise AssertionError(f"{label}: an append of {BUFFER_FRAMES} "
                                 f"frames ({data:.0f} bytes of rows) grew "
                                 f"the files by {min(grow)}-{max(grow)}")
        flushes.append({"frame": k + 1, "ms_per_slot": statistics.median(ms),
                        "ms_all_slots": sum(ms), "wall_s": wall,
                        "growth_per_slot": statistics.median(grow),
                        "datasets": n_ds})
    for lg in loggers:
        lg.close()
    for i, p in enumerate(paths):
        with h5.File(p) as f:
            pos = f["output/pos"][()]
            if {ds.shape[0] for _, ds in f["output"].items()} != {
                    CLI_APPEND_FRAMES}:
                raise AssertionError(f"{label}: {p} does not hold "
                                     f"{CLI_APPEND_FRAMES} frames")
        want = np.stack([values[k % len(values)][1]["pos"][i][None]
                         for k in range(CLI_APPEND_FRAMES)])
        if not np.array_equal(pos, want.astype(np.float32)):
            raise AssertionError(f"{label}: {p} positions differ from "
                                 "those logged")
    res = {"frames": CLI_APPEND_FRAMES, "flushes": flushes,
           "buffer_ms_a_frame": 1e3 * statistics.median(buffer_s),
           "rows_bytes_a_flush_per_slot": BUFFER_FRAMES * frame_bytes}
    create, rest = flushes[0], flushes[1:]
    log(f"[{label}] {CLI_APPEND_FRAMES} frames of the run's values "
        f"replayed through cli.log_values into {n} new files: a frame "
        f"buffered in {res['buffer_ms_a_frame']:.3f} ms (all {n} slots, "
        f"median); creating flush {create['ms_per_slot']:.3f} ms a slot "
        f"(median; all {n} {create['ms_all_slots']:.1f} ms, the file +"
        f"{create['growth_per_slot']:.0f} bytes); appending flushes of "
        f"{BUFFER_FRAMES} frames "
        + ", ".join(f"{f['ms_per_slot']:.3f} ms a slot (all {n} "
                    f"{f['ms_all_slots']:.1f} ms, +{f['growth_per_slot']:.0f}"
                    " bytes)" for f in rest)
        + f" against {BUFFER_FRAMES * frame_bytes:.0f} bytes of rows a slot; "
        f"{create['datasets']} datasets a file; every file read back")
    return res


def cli_ubiquitin(dev, path):
    """`cli.main` on ubiquitin x CLI_SLOTS slots at the detailed level,
    CLI_ROUNDS rounds, frames every CLI_EVERY, into a temporary directory,
    beside a bare `run_ensemble` under the same schedule without logging;
    launch counts set to 0 just before each and read just after.  Checks:
    K1 fwd, K1 bwd and K2 launched as often as by the bare run, over as
    many evaluations; every file read by the port's reader, every frame
    finite; the logged potential equal to `System.energy` at the logged
    positions (rel 1e-5); frame 1's streams of the first CLI_HOST_SLOTS
    slots (from the files) equal to the port on the CPU in float64 (within
    1e-4 of each stream's largest value, or of 1e-6 where that is smaller).
    steps/s with logging counts from `run_ensemble`'s start to the last
    file's close, so every file write is inside (with 6 frames all of them
    happen at the close, each creating its datasets); the append path,
    which a run of fewer than BUFFER_FRAMES frames does not reach, is
    timed by `replay_appends` on the same frames' values."""
    import tempfile
    import numpy as np
    import torch
    from upside_md_torch import cli
    from upside_md_torch.io.streams import make_frame_fn
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.ops import kernels
    n, label = CLI_SLOTS, "cli ubiquitin"
    temps = [1.0] * n
    system, pos0 = load_system(path, dev)
    sim = Simulation(system, dt=0.009, duration=CLI_ROUNDS * 3 * 0.009,
                     thermostat_interval=0.135,
                     frame_interval=CLI_EVERY * 3 * 0.009, seed=42)
    state = sim.initial_state(pos0, n, temps)
    kernels.reset_counts()
    with _Recorded() as bare_rec:
        bare, bare_out = cli.run_ensemble(sim, state, system.params,
                                          frozenset(), sim.n_round)
    bare_launches = dict(kernels.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        with _Recorded() as rec:
            rc = cli.main(cli_flags(CLI_ROUNDS, CLI_EVERY, temps, tmp)
                          + [path] * n)
        launches = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        state, out = rec.runs[0]
        paths = [cli.output_path(tmp, path, i) for i in range(n)]
        t0 = time.perf_counter()
        frames = read_frames(paths)
        read_s = time.perf_counter() - t0
        n_frame = frames["pos"].shape[1]
        nbytes = sum(os.path.getsize(p) for p in paths)
        frame_bytes = sum(a[0].nbytes for a in frames.values()) / n_frame
        flush_ms = [1e3 * sum(lg.flush_seconds) for lg in rec.loggers]
        appends = replay_appends(cli, rec.values, tmp, n, frame_bytes)
    evals = state.n_evals + out["n_energy_evals"]
    bare_evals = bare.n_evals + bare_out["n_energy_evals"]
    for nm in FUSED_KERNELS:
        if launches[nm] <= 0 or launches[nm] != bare_launches[nm]:
            raise AssertionError(f"{label}: {nm} launched {launches[nm]} "
                                 f"times, the bare run {bare_launches[nm]}")
    if evals != bare_evals:
        raise AssertionError(f"{label}: {evals} evaluations, the bare run "
                             f"{bare_evals}")
    per_eval = {nm: launches[nm] / evals for nm in FUSED_KERNELS}
    # the logged potential against a fresh evaluation of the logged frame
    worst = 0.0
    for k in range(n_frame):
        x = torch.as_tensor(frames["pos"][:, k, 0], device=dev)
        e = system.energy(x).double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(
            frames["potential"][:, k, 0] - e) / np.abs(e))))
    check(f"{label}: logged potential against System.energy at the "
          f"logged positions ({n} slots x {n_frame} frames)", worst, 1e-5)
    # frame 1's streams against the port on the CPU in float64
    host = load_system(path, "cpu", dtype="float64")[0]
    frame_fn, _ = make_frame_fn(host, "detailed")
    m = CLI_HOST_SLOTS
    _, want, _ = frame_fn(torch.as_tensor(frames["pos"][:m, 0, 0],
                                          dtype=torch.float64),
                          n_deriv_evals=3 * CLI_EVERY)
    stream_err = {}
    for k, v in want.items():
        # relative to the stream's largest value, floored at 1e-6 (a
        # stream that is zero throughout is held to 1e-10 absolute)
        d = rel_err(torch.as_tensor(frames[k][:m, 0]), v)[1]
        stream_err[k] = d / max(v.abs().max().item(), 1e-6)
        check(f"{label}: frame 1 stream {k}, card (its file) vs CPU "
              f"float64 ({m} slots; abs {d:.3e})", stream_err[k], 1e-4)
    steps = 3 * CLI_ROUNDS * n
    rate, bare_rate = steps / out["seconds"], steps / bare_out["seconds"]
    # through the files: run_ensemble's call to the last logger's close
    files_s = max(rec.close_t) - rec.run_t[0][0]
    bare_call_s = bare_rec.run_t[0][1] - bare_rec.run_t[0][0]
    files_rate, bare_call_rate = steps / files_s, steps / bare_call_s
    frame_ms = 1e3 * statistics.median(rec.frame_s)
    bare_frame_ms = 1e3 * statistics.median(bare_rec.frame_s)
    res = {"steps_per_s_with_files": files_rate,
           "bare_steps_per_s_call": bare_call_rate,
           "seconds_with_files": files_s, "bare_seconds_call": bare_call_s,
           "loop_steps_per_s": rate, "bare_loop_steps_per_s": bare_rate,
           "seconds": out["seconds"], "bare_seconds": bare_out["seconds"],
           "frames": n_frame, "ms_per_frame": frame_ms,
           "bare_ms_per_frame": bare_frame_ms,
           "bytes_per_frame_per_slot": frame_bytes,
           "file_bytes_per_slot": nbytes / n,
           "create_flush_ms_per_slot": statistics.median(flush_ms),
           "create_flush_ms_all_slots": sum(flush_ms), "read_s": read_s,
           "appends": appends,
           "launches": launches, "launches_per_eval": per_eval,
           "evaluations": evals, "potential_rel": worst,
           "stream_rel": stream_err}
    log(f"[{label}] {n} slots, {CLI_ROUNDS} rounds, frames every "
        f"{CLI_EVERY}: cli.main {files_rate:.1f} steps/s with logging, "
        f"from run_ensemble's start to the last file's close "
        f"({files_s:.3f} s; the loop alone {rate:.1f} steps/s, "
        f"{out['seconds']:.3f} s), run_ensemble without logging "
        f"{bare_call_rate:.1f} steps/s (its call {bare_call_s:.3f} s; the "
        f"loop alone {bare_rate:.1f} steps/s, {bare_out['seconds']:.3f} s) "
        "under the same schedule")
    log(f"[{label}] {frame_ms:.2f} ms a frame (median of {n_frame}: "
        f"evaluation with the streams + copies + buffering, no file write; "
        f"the bare run's evaluation and copies {bare_frame_ms:.2f} ms), "
        f"{frame_bytes:.0f} bytes a frame "
        f"a slot ({nbytes / n:.0f} bytes a file), the close's flush of a "
        f"slot's {n_frame} frames, creating its datasets, "
        f"{res['create_flush_ms_per_slot']:.2f} ms (median; all {n} files "
        f"{res['create_flush_ms_all_slots']:.1f} ms), reading all files "
        f"{read_s:.2f} s")
    log(f"[{label}] launches {launches}; per evaluation {per_eval} "
        f"({evals} evaluations, as the bare run's)")
    # K5 fwd too: the frames' rotamer streams build the unfused grid
    return res, launches


def cli_rex(dev, path, phase7):
    """BASELINE config 4 through the command line: CLI_SLOTS ladder bundles
    (the first spring node's spring_const scaled as `ladder` scales it)
    written with `bundle.save`, temperatures 0.80 1.02^i, even/odd swap
    sets every REX_EVERY rounds, CLI_REX_ROUNDS rounds, launch counts set
    to 0 just before and read just after; K1 fwd, K1 bwd and K2 launched,
    replica_index a permutation in every frame; swap acceptance and steps/s
    beside phase 7's."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from upside_md_torch import cli
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels
    n, label = CLI_SLOTS, "cli rex cytochrome_c"
    specs, pos0 = bundle.load(path)
    aux = bundle.load_aux(path)
    node = next(s for s in specs if "spring" in s.name
                and "spring_const" in s.params)

    def save(i, tmp):
        f = 1.0 + 0.02 * (i / max(n - 1, 1) - 0.5)
        recs = [dataclasses.replace(s, params={
            **s.params, "spring_const": np.asarray(
                s.params["spring_const"], np.float32) * np.float32(f)})
            if s is node else s for s in specs]
        return bundle.save(os.path.join(tmp, f"cytc_{i:02d}.npz"), recs,
                           pos0, aux)

    even = ",".join(f"{i}-{i + 1}" for i in range(0, n - 1, 2))
    odd = ",".join(f"{i}-{i + 1}" for i in range(1, n - 1, 2))
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(8) as pool:
            paths = list(pool.map(lambda i: save(i, tmp), range(n)))
        kernels.reset_counts()
        with _Recorded() as rec:
            rc = cli.main(cli_flags(CLI_REX_ROUNDS, REX_EVERY,
                                    0.80 * 1.02 ** np.arange(n), tmp)
                          + [f"--replica-interval={REX_EVERY * 3 * 0.009}",
                             f"--swap-set={even}", f"--swap-set={odd}"]
                          + paths)
        launches = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        frames = read_frames([cli.output_path(tmp, p, i)
                              for i, p in enumerate(paths)])
    state, out = rec.runs[0]
    for k in range(frames["replica_index"].shape[1]):
        if sorted(frames["replica_index"][:, k, 0].tolist()) != \
                list(range(n)):
            raise AssertionError(f"{label}: replica_index of frame {k} is "
                                 "not a permutation")
    for nm in FUSED_KERNELS:
        if launches[nm] <= 0:
            raise AssertionError(f"kernel {nm} was not launched by {label}")
    stats = np.concatenate([s.cpu().numpy() for s in out["rex_stats"]]
                           ).sum(0)
    swap_acc = float(stats[0] / stats[1])
    rate = 3 * CLI_REX_ROUNDS * n / out["seconds"]
    evals = state.n_evals + out["n_energy_evals"]
    per_eval = {nm: launches[nm] / evals for nm in FUSED_KERNELS}
    res = {"steps_per_s": rate, "seconds": out["seconds"],
           "swap_acceptance": swap_acc, "swaps": stats.tolist(),
           "phase7_steps_per_s": phase7["steps_per_s"],
           "phase7_swap_acceptance": phase7["swap_acceptance"],
           "launches": launches, "launches_per_eval": per_eval}
    log(f"[{label}] {n} ladder bundles, {CLI_REX_ROUNDS} rounds: "
        f"{rate:.1f} steps/s with the swaps and logging "
        f"({out['seconds']:.3f} s), swap acceptance {swap_acc:.4f} "
        f"({stats[0]} of {stats[1]}); phase 7's run_ensemble "
        f"{phase7['steps_per_s']:.1f} steps/s, acceptance "
        f"{phase7['swap_acceptance']:.4f}; per evaluation {per_eval}")
    return res, {nm: launches[nm] for nm in FUSED_KERNELS}


def cli_pda(path):
    """--potential-deriv-agreement through `cli.main` on ubiquitin on the
    card (one round, one slot): the per-term energies and the relative
    RMS deviation of the autograd forces from central differences (step
    1e-3, float32, each shifted configuration's BP solved cold at the
    bundle's tol), which must be finite."""
    import contextlib
    import io
    import tempfile
    from upside_md_torch import cli
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(cli_flags(1, 1, [1.0], tmp)
                          + ["--potential-deriv-agreement", path])
        seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli pda: main returned {rc}")
    lines = buf.getvalue().splitlines()
    rel = float(next(ln for ln in lines
                     if "relative error" in ln).split()[-1])
    if not math.isfinite(rel):
        raise AssertionError(f"cli pda: relative error {rel}")
    terms = lines[:lines.index(next(ln for ln in lines
                                    if "relative error" in ln))]
    log(f"[cli pda] ubiquitin: overall potential relative error {rel:.5f} "
        f"({seconds:.1f} s the whole call); "
        + "; ".join(t.strip() for t in terms))
    return {"relative_error": rel, "seconds": seconds, "terms": terms}


def host_ms(fn, reps):
    """[ms of each of `reps` calls of fn()] on the host's clock, and the
    last call's value."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return times, out


def same_records(label, got, want):
    """A `.up`'s records (`config/reader.py`) against a bundle's: names,
    types and args equal; Python scalars and every array that is read as
    it is stored equal; the coefficients fitted at load time (float
    arrays whose name is `coeffs`, `cb_coeff` or `uhb_coeff`) within rel
    UP_FIT_TOL of their largest |value|, since `np.linalg.inv` may round
    differently on another host.  Returns the worst fitted error."""
    import numpy as np
    want = {r.name: r for r in want}
    if sorted(r.name for r in got) != sorted(want):
        raise AssertionError(f"{label}: node names differ")
    worst = 0.0
    for g in got:
        w = want[g.name]
        if (g.type_name, g.args) != (w.type_name, w.args):
            raise AssertionError(f"{label}: {g.name} type or args differ")
        for part in ("consts", "params"):
            a, b = getattr(g, part), getattr(w, part)
            extra = set(a) - set(b)
            if set(b) - set(a) or extra - {"raw_map"} or (
                    extra and g.type_name != "rama_map_pot"):
                raise AssertionError(f"{label}: {g.name} {part} keys differ")
            for k, v in b.items():
                x = a[k]
                if not isinstance(v, np.ndarray):
                    if type(x) is not type(v) or x != v:
                        raise AssertionError(f"{label}: {g.name}/{k} differs")
                    continue
                if x.dtype != v.dtype or x.shape != v.shape:
                    raise AssertionError(f"{label}: {g.name}/{k} dtype or "
                                         "shape differs")
                if k in ("coeffs", "cb_coeff", "uhb_coeff"):
                    err = float(np.abs(x.astype(np.float64) - v).max()
                                / max(np.abs(v).max(), 1e-30))
                    worst = max(worst, err)
                    check(f"{label}: fitted {g.name}/{k}", err, UP_FIT_TOL)
                elif not np.array_equal(x, v):
                    raise AssertionError(f"{label}: {g.name}/{k} differs")
    return worst


def up_ubiquitin(dev, up_path, npz_path):
    """[up ubiquitin]: the committed `.up` read without h5py against the
    committed bundle of the same build.  Host ms (UP_LOAD_REPS calls each)
    of `reader.load_up` beside `bundle.load`, and load_up's two parts
    timed apart: reading every dataset of the file through `io/h5.py`, and
    the float64 spline fits it runs (the Rama maps and the Rama-dependent
    placement).  Gates: the records as `same_records` holds them; energy
    and force RMS of `System.from_up` against `System.from_bundle` at the
    stored positions tiled to TIME_REPLICAS replicas, rel UP_EVAL_TOL."""
    import numpy as np
    import torch
    from upside_md_torch.config import bundle, reader
    from upside_md_torch.io import h5
    from upside_md_torch.nodes.placement import make_rama_placement_params
    from upside_md_torch.nodes.rama import make_rama_map_params
    from upside_md_torch.system import System
    label = "up ubiquitin"

    def read_all():
        arrays = {}
        with h5.File(up_path) as f:
            f.visititems(lambda k, o: arrays.__setitem__(k, o[()])
                         if isinstance(o, h5.Dataset) else None)
        return arrays

    load_ms, (recs, pos, aux) = host_ms(lambda: reader.load_up(up_path),
                                        UP_LOAD_REPS)
    bundle_ms, (brecs, bpos) = host_ms(lambda: bundle.load(npz_path),
                                       UP_LOAD_REPS)
    read_ms, arrays = host_ms(read_all, UP_LOAD_REPS)
    pot = "input/potential/"
    fits = [(make_rama_map_params, arrays[pot + "rama_map_pot/rama_pot"]),
            (make_rama_placement_params,
             arrays[pot + "placement_scalar/placement_data"])]
    fit_ms, _ = host_ms(lambda: [fn(a) for fn, a in fits], UP_LOAD_REPS)
    fit_err = same_records(label, recs, brecs)
    if not np.array_equal(pos, bpos):
        raise AssertionError(f"{label}: positions differ from the bundle's")
    n_bytes = os.path.getsize(up_path)
    sys_u, pos_u = System.from_up(up_path, dev)
    sys_b, pos_b = System.from_bundle(npz_path, dev)
    x = tiled(pos_b[None], TIME_REPLICAS)
    g_u, e_u, _ = sys_u.deriv(tiled(pos_u[None], TIME_REPLICAS))
    g_b, e_b, _ = sys_b.deriv(x)
    e_err = rel_err(e_u, e_b)[0]
    f_err = ((g_u.double() - g_b.double()).pow(2).mean().sqrt()
             / g_b.double().pow(2).mean().sqrt()).item()
    check(f"{label}: energy, System.from_up vs from_bundle "
          f"({TIME_REPLICAS} replicas)", e_err, UP_EVAL_TOL)
    check(f"{label}: force RMS, System.from_up vs from_bundle", f_err,
          UP_EVAL_TOL)
    med = statistics.median
    res = {"file_bytes": n_bytes, "datasets": len(arrays),
           "load_up_ms": load_ms, "bundle_load_ms": bundle_ms,
           "h5_read_ms": read_ms, "fit_ms": fit_ms,
           "fit_max_rel": fit_err, "energy_rel": e_err, "force_rms_rel": f_err,
           "aux": sorted(aux)}
    log(f"[{label}] {os.path.basename(up_path)} ({n_bytes} bytes, "
        f"{len(arrays)} datasets): load_up {med(load_ms):.1f} ms (median "
        f"of {UP_LOAD_REPS}; {min(load_ms):.1f}-{max(load_ms):.1f}) = HDF5 "
        f"read of every dataset {med(read_ms):.1f} ms + the float64 fits "
        f"{med(fit_ms):.1f} ms (Rama maps and Rama placement, timed "
        f"apart) + the rest; bundle.load of the .npz {med(bundle_ms):.1f} "
        f"ms; fitted coefficients vs the bundle's max rel {fit_err:.2e}, "
        f"every other array equal; energy rel {e_err:.2e}, force RMS rel "
        f"{f_err:.2e} at {TIME_REPLICAS} replicas; aux {sorted(aux)}")
    return res, sys_u, sys_b, pos_b


def cli_up(dev, up_path, npz_path):
    """[cli up ubiquitin]: `cli.main` on the committed `.up` at CLI_SLOTS
    slots, CLI_ROUNDS rounds, frames every CLI_EVERY, beside the same run
    from the bundle, in the order bundle, .up, .up, bundle; launch counts
    set to 0 just before each run and read just after.  Gates: K1 fwd, K1
    bwd and K2 launched as often by each `.up` run as by the bundle runs,
    over as many evaluations; the logged potential at frame 1 equal to the
    bundle run's within rel UP_EVAL_TOL.  Prints steps/s of each run (the
    loop, and to the last file's close), `cli.main`'s whole wall time, the
    `.up`'s load included, and for each later run the logged datasets not
    bitwise equal to the first bundle run's."""
    import tempfile
    import numpy as np
    from upside_md_torch import cli
    from upside_md_torch.ops import kernels
    label = "cli up ubiquitin"
    n = CLI_SLOTS
    runs = {"npz": [], "up": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (kind, path) in enumerate((("npz", npz_path), ("up", up_path),
                                          ("up", up_path),
                                          ("npz", npz_path))):
            out_dir = os.path.join(tmp, f"run{k}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            with _Recorded() as rec:
                rc = cli.main(cli_flags(CLI_ROUNDS, CLI_EVERY, [1.0] * n,
                                        out_dir) + [path] * n)
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"{label}: main returned {rc} on {path}")
            state, out = rec.runs[0]
            frames = read_frames([cli.output_path(out_dir, path, i)
                                  for i in range(n)])
            steps = 3 * CLI_ROUNDS * n
            runs[kind].append({
                "loop_steps_per_s": steps / out["seconds"],
                "steps_per_s_with_files":
                    steps / (max(rec.close_t) - rec.run_t[0][0]),
                "main_wall_s": wall,
                "evaluations": state.n_evals + out["n_energy_evals"],
                "launches": launches, "frames": frames})
    first = runs["npz"][0]
    for r in runs["up"] + runs["npz"][1:]:
        for nm in FUSED_KERNELS:
            if r["launches"][nm] <= 0 or r["launches"][nm] != \
                    first["launches"][nm]:
                raise AssertionError(f"{label}: {nm} launched "
                                     f"{r['launches'][nm]} times, the "
                                     f"bundle run {first['launches'][nm]}")
        if r["evaluations"] != first["evaluations"]:
            raise AssertionError(f"{label}: {r['evaluations']} evaluations, "
                                 f"the bundle run {first['evaluations']}")
    want = first["frames"]["potential"][:, 0]
    pot_err = max(float(np.max(np.abs(r["frames"]["potential"][:, 0] - want)
                               / np.abs(want))) for r in runs["up"])
    check(f"{label}: logged potential at frame 1, .up vs bundle ({n} "
          "slots)", pot_err, UP_EVAL_TOL)
    # every logged dataset of a run against the first bundle run's: the
    # names of those not bitwise equal, and the last frame's largest
    # position difference; the second bundle run shows the card's own
    # run-to-run spread
    def deviation(r):
        return (sorted(k for k in first["frames"]
                       if not np.array_equal(r["frames"][k],
                                             first["frames"][k])),
                float(np.abs(r["frames"]["pos"][:, -1]
                             - first["frames"]["pos"][:, -1]).max()))
    same = {kind: [deviation(r) for r in runs[kind][kind == "npz":]]
            for kind in runs}
    evals = first["evaluations"]
    per_eval = {nm: first["launches"][nm] / evals for nm in FUSED_KERNELS}
    res = {kind: [{k: v for k, v in r.items() if k != "frames"} for r in rs]
           for kind, rs in runs.items()}
    res.update(potential_rel=pot_err, frames_vs_first_bundle_run=same,
               launches_per_eval=per_eval)
    fmt = ", ".join
    log(f"[{label}] {n} slots, {CLI_ROUNDS} rounds, frames every "
        f"{CLI_EVERY}, order npz, up, up, npz: loop steps/s .up "
        + fmt(f"{r['loop_steps_per_s']:.1f}" for r in runs["up"])
        + " / .npz " + fmt(f"{r['loop_steps_per_s']:.1f}"
                           for r in runs["npz"])
        + "; to the last file's close .up "
        + fmt(f"{r['steps_per_s_with_files']:.1f}" for r in runs["up"])
        + " / .npz " + fmt(f"{r['steps_per_s_with_files']:.1f}"
                           for r in runs["npz"])
        + "; cli.main wall .up "
        + fmt(f"{r['main_wall_s']:.2f} s" for r in runs["up"])
        + " / .npz " + fmt(f"{r['main_wall_s']:.2f} s" for r in runs["npz"]))
    log(f"[{label}] launches per evaluation {per_eval} in each run "
        f"({evals} evaluations); frame-1 potential rel {pot_err:.2e}; "
        "against the first bundle run, the logged datasets not bitwise "
        "equal and the last frame's largest position difference (A): .up "
        + fmt(f"{names} {d:.3e}" for names, d in same["up"])
        + ", the second .npz run "
        + fmt(f"{names} {d:.3e}" for names, d in same["npz"]))
    return res, runs["up"][0]["launches"]


def up_rama(sys_u, sys_b, pos):
    """[up rama]: `rama_map_pot`'s get_param on the `.up` system (its
    float64 raw map) against the bundle system (the knot values of its
    coefficients), rel UP_EVAL_TOL of the largest |value|; then on each
    system set_param(get_param()) must leave the energy at the stored
    positions within rel UP_EVAL_TOL."""
    import numpy as np
    from upside_md_torch.engine import Upside
    label, node = "up rama", "rama_map_pot"
    eng_u = Upside(sys_u, initial_pos=pos)
    eng_b = Upside(sys_b, initial_pos=pos)
    raw_u, raw_b = eng_u.get_param(node), eng_b.get_param(node)
    if raw_u.dtype != np.float64 or raw_u.shape != raw_b.shape:
        raise AssertionError(f"{label}: get_param gave {raw_u.dtype} "
                             f"{raw_u.shape}, {raw_b.shape}")
    map_err = float(np.abs(raw_u - raw_b).max() / np.abs(raw_u).max())
    check(f"{label}: get_param, .up raw map vs the bundle's knot values",
          map_err, UP_EVAL_TOL)
    x = pos.cpu().numpy()
    res = {"map_rel": map_err, "map_values": int(raw_u.size)}
    for kind, eng in (("up", eng_u), ("bundle", eng_b)):
        e0 = eng.energy(x)
        eng.set_param(eng.get_param(node), node)
        e1 = eng.energy(x)
        err = abs(e1 - e0) / abs(e0)
        check(f"{label}: energy after set_param(get_param()), {kind}", err,
              UP_EVAL_TOL)
        res[f"{kind}_energy_rel"] = err
    log(f"[{label}] get_param: {raw_u.size} float64 values, .up vs bundle "
        f"max rel {map_err:.2e}; set_param(get_param()) energy rel "
        f"{res['up_energy_rel']:.2e} (.up), {res['bundle_energy_rel']:.2e} "
        "(bundle)")
    return res


def main():
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, ROOT)
    from upside_md_torch import DATA_DIR
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {"phases": {}}
    fused_path = os.path.join(DATA_DIR, BUNDLE)
    unfused_path = os.path.join(DATA_DIR, BUNDLE_UNFUSED)
    noenv_path = os.path.join(DATA_DIR, BUNDLE_NOENV)

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

    # ---- 3. kernel vs plain at each path's shapes
    gen = torch.Generator(device=dev).manual_seed(7)
    base_f = torch.as_tensor(bundle.load(fused_path)[1], device=dev)
    base_u = torch.as_tensor(bundle.load(unfused_path)[1], device=dev)
    base_n = torch.as_tensor(bundle.load(noenv_path)[1], device=dev)
    errs, whole_f, layout_f = compare_fused(dev, gen, base_f, fused_path)
    errs_u, whole_u, layout_u = compare_unfused(dev, gen, base_u,
                                                unfused_path)
    errs_n, whole_n, layout_n = compare_noenv(dev, gen, base_n, noenv_path)
    errs.update(errs_u)
    for part in (errs_n, compare_bp_cases(dev)):
        for nm, e in part.items():
            errs[nm] = max(errs[nm], e)
    results["phases"]["compare"] = {"max_abs_err": errs,
                                    "ubiquitin": whole_f,
                                    "rnase_a": whole_u,
                                    "ubiquitin_noenv": whole_n,
                                    "bp_layout": {
                                        "ubiquitin": layout_f,
                                        "rnase_a": layout_u,
                                        "ubiquitin_noenv": layout_n}}
    torch.cuda.empty_cache()

    # ---- 4. timing, kernel vs plain, at 64 replicas with the config's BP
    # tolerance and a warm start, as in MD
    ms, bounds, before, lat, passes, rows = time_fused(dev, gen, base_f,
                                                       fused_path)
    ms_u, bounds_u, before_u, lat_u, passes_u, rows_u = time_unfused(
        dev, gen, base_u, unfused_path)
    passes.update(passes_u)
    before.update(before_u)
    rows.update(rows_u)
    ms_n, bounds_n, before_n, rows_n = time_noenv(dev, gen, base_n,
                                                  noenv_path)
    before.update(before_n)
    rows.update(rows_n)
    for part in (ms_u, ms_n):
        ms.update(part)
    bounds.update(bounds_u)
    bounds.update(bounds_n)
    lat.update(lat_u)
    for nm in kernels.KERNELS:
        dms = "not measured" if ms[nm][2] is None else f"{ms[nm][2]:.4f} ms"
        log(f"[time] {nm}: kernel {ms[nm][0]:.4f} ms a call on an idle "
            f"card, device time of its launches {dms}, plain "
            f"{ms[nm][1]:.4f} ms, bound {bounds[nm][0]:.4f} ms "
            f"({bounds[nm][1]}){as_before(before.get(nm))}, {TIME_REPLICAS} "
            "replicas")
    for nm, (per, floor) in lat.items():
        log(f"[time] {nm}: {per:.5f} ms per dependent sweep (slope over "
            f"{SWEEPS_LO} and {SWEEPS_HI} sweeps), latency floor "
            f"{floor:.4f} ms for the timed run's sweeps")
    results["phases"]["time_ms"] = ms
    results["phases"]["bound_ms"] = bounds
    results["phases"]["bound_table_ms"] = before
    results["phases"]["sweep_latency_ms"] = lat
    results["phases"]["bp_passes"] = passes
    results["phases"]["row_tile"] = rows

    # ---- 5. MD through each path
    md_f, launches_f = run_md(fused_path, dev, "ubiquitin", FUSED_KERNELS,
                              max_sweeps=MAX_MEAN_SWEEPS)
    md_u, launches_u = run_md(unfused_path, dev, "RNase A", UNFUSED_KERNELS)
    md_n, launches_n = run_md(noenv_path, dev, "no-env ubiquitin",
                              NOENV_KERNELS, absent=("fused_pair_bwd",),
                              max_sweeps=MAX_MEAN_SWEEPS)
    results["phases"]["md"] = {"ubiquitin": md_f, "rnase_a": md_u,
                               "ubiquitin_noenv": md_n}

    # ---- 6. training through K3 and the table cotangents
    train, launches_t = run_train(noenv_path, dev, gen, base_n)
    results["phases"]["train"] = train

    # ---- 7. replica exchange: BASELINE config 4 on cytochrome c
    rex_path = os.path.join(DATA_DIR, BUNDLE_REX)
    base_r = torch.as_tensor(bundle.load(rex_path)[1], device=dev)
    rex = {"gate": compare_rex(dev, gen, base_r, rex_path)}
    rex["config4"], launches_r = rex_run(rex_path, dev, mc=False)
    rex["config4_pivot"], launches_rm = rex_run(rex_path, dev, mc=True)
    results["phases"]["rex"] = rex

    # ---- 8. proteins past 128 residues and 1,024 beads
    t4_path = os.path.join(DATA_DIR, BUNDLE_T4)
    gfp_path = os.path.join(DATA_DIR, BUNDLE_GFP)
    large = {"t4_lysozyme": large_t4(
        dev, gen, torch.as_tensor(bundle.load(t4_path)[1], device=dev),
        t4_path)}
    large["t4_lysozyme"]["md"], launches_t4, _ = large_md(
        t4_path, dev, "large t4_lysozyme", T4_MD_REPLICAS, LARGE_KERNELS,
        LARGE_ROUNDS)
    large["gfp"] = {"gate": large_gfp_gate(
        dev, gen, torch.as_tensor(bundle.load(gfp_path)[1], device=dev),
        gfp_path)}
    large["gfp"]["md"], launches_gfp, last = large_md(
        gfp_path, dev, "large gfp", GFP_MD_REPLICAS, (), LARGE_ROUNDS)
    large["gfp"]["nl"] = large_nl(
        gfp_path, dev, last,
        large["gfp"]["md"][GFP_MD_REPLICAS[0]]["device_s_per_eval"] * 1e3)
    results["phases"]["large"] = large

    # ---- 9. the remaining node types: config 2, chi1, the extras
    rest = {}
    rest["config2"], launches_c2 = config2(
        dev, gen, os.path.join(DATA_DIR, BUNDLE_RADIAL), fused_path)
    rest["chi1"], launches_chi1 = chi1_phase(
        dev, gen, os.path.join(DATA_DIR, BUNDLE_CHI1))
    rest["extras"], launches_x = extras_phase(
        dev, gen, os.path.join(DATA_DIR, BUNDLE_EXTRAS))
    results["phases"]["remaining_nodes"] = rest

    # ---- 10. the command line and its trajectory files
    t0 = time.perf_counter()
    cli_res = {}
    cli_res["ubiquitin"], launches_cli = cli_ubiquitin(dev, fused_path)
    cli_res["rex"], launches_cli_rex = cli_rex(dev, rex_path,
                                               rex["config4"])
    cli_res["pda"] = cli_pda(fused_path)
    cli_res["seconds"] = time.perf_counter() - t0
    log(f"[cli] phase 10 took {cli_res['seconds']:.1f} s")
    results["phases"]["cli"] = cli_res

    # ---- 11. .up configurations read without h5py
    t0 = time.perf_counter()
    up_path = os.path.join(DATA_DIR, BUNDLE_UP)
    up_res = {}
    up_res["load"], sys_u, sys_b, pos_b = up_ubiquitin(dev, up_path,
                                                       fused_path)
    up_res["rama"] = up_rama(sys_u, sys_b, pos_b)
    del sys_u, sys_b
    up_res["cli"], launches_up = cli_up(dev, up_path, fused_path)
    up_res["seconds"] = time.perf_counter() - t0
    log(f"[up] phase 11 took {up_res['seconds']:.1f} s")
    results["phases"]["up"] = up_res
    per_path = {"md ubiquitin": launches_f, "md rnase_a": launches_u,
                "md ubiquitin_noenv": launches_n, "train": launches_t,
                "rex cytochrome_c": launches_r,
                "rex cytochrome_c pivot": launches_rm,
                "md t4_lysozyme": launches_t4, "md gfp": launches_gfp,
                "md config2 ubiquitin_radial": launches_c2,
                "chi1 ubiquitin": launches_chi1,
                "md extras trp_cage": launches_x,
                "cli ubiquitin": launches_cli,
                "cli rex cytochrome_c": launches_cli_rex,
                "cli up ubiquitin": launches_up}
    results["phases"]["launches"] = per_path
    launches = {nm: sum(p.get(nm, 0) for p in per_path.values())
                for nm in kernels.KERNELS}

    # ---- 12. report
    table = {"kernels": [
        {"name": nm, "route": "cuda", "source": KERNEL_INFO[nm][0],
         "replaces": KERNEL_INFO[nm][1], "launches": launches[nm],
         "max_abs_err": errs[nm], "ms": ms[nm][0],
         "device_ms": ms[nm][2], "plain_ms": ms[nm][1],
         "bound_ms": bounds[nm][0], "bound_by": bounds[nm][1],
         "library_ms": None,
         **({"bound_table_ms": before[nm][0]} if nm in before else {})}
        for nm in kernels.KERNELS]}
    results.update(table)
    results["total_s"] = time.perf_counter() - t_start
    log(f"[done] total run time {results['total_s']:.1f} s")
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
