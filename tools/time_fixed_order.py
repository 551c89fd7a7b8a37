#!/usr/bin/env python3
"""Times the paths that the port's fixed-order sums run through, in the
`upside_md_torch` of the current directory, on one NVIDIA GPU, and prints
one JSON object as its last line.

    python3 tools/time_fixed_order.py [--label NAME] [--rounds 10]
        [--forms | --cotangents] [--out FILE]

What it measures:

* `md`: MD steps/s (bench.py's timing: one warm-up `advance` of
  `--rounds` rounds, then the median of three, each ended by a device
  synchronisation and a host fetch) at 64 and 512 replicas on BASELINE
  config 1 trp-cage (`bench_systems.build_backbone_system`, whose only
  pair term is `backbone_pairs`) and on full-force-field ubiquitin (the
  committed `ubiquitin_full_synth.npz`, bench_torch.py's system);
* `launches`: for one force evaluation (`System.deriv`, warm BP cache)
  at 64 replicas on config 1 trp-cage and ubiquitin and on full
  ubiquitin, the device kernels and copies `torch.profiler` records
  (null where it records none), and the aten operations the evaluation
  dispatches, views left out;
* `cotangent_ms`: `fused_pair.block_table_cotangents` on full ubiquitin
  at 64 perturbed replicas under random cotangents: the rotamer table
  alone, the three spline tables together, and the environment table
  alone (`env_table_cotangent`) (CUDA-event median of 5 after a
  warm-up);
* `train_s`: the training step of tools/bench_all_torch.py's training
  row (the energy-match loss over 64 perturbed ubiquitin conformations,
  every floating parameter's gradient, an SGD update, through
  `parallel.mesh.sharded_training_step` on one rank): seconds a step
  over 10 chained steps a sync, and one step's wall time.

With `--cotangents` it times only `cotangent_ms` and `train_s`.  With
`--forms` it times instead, in this tree only, the forms of
`backbone_pairs`' sums (`_forms`: the parent's `.sum`, two earlier
halving forms, the current node) at 64 and 512 replicas of ubiquitin,
trp-cage and cytochrome c: the node's forward and backward
(`torch.autograd.grad` to its input) as wall ms and CUDA-event ms a call,
its device launches, and whether a replica's energy is bitwise the same
in a batch of 64 as in 4 x 16.

It uses only functions that every version of the port since the
multi-device slice has, so two trees can be compared on one card within
one command, in turns (OLD_TREE's kernels build in its own directory):

    (cd OLD_TREE && python3 NEW_TREE/tools/time_fixed_order.py --label old)
    python3 tools/time_fixed_order.py --label new
"""

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from upside_md_torch import DATA_DIR, bench_systems  # noqa: E402
from upside_md_torch.md.sim import Simulation  # noqa: E402
from upside_md_torch.system import System  # noqa: E402

REPLICAS = (64, 512)
VIEWS = {"view", "_unsafe_view", "slice", "select", "expand", "unsqueeze",
         "squeeze", "permute", "t", "transpose", "detach", "alias",
         "as_strided", "reshape", "_reshape_alias", "split", "unbind",
         "lift_fresh", "split_with_sizes", "narrow"}


def sync_fetch(t):
    torch.cuda.synchronize()
    return float(t.sum())


def timed(fn, sync, n=3):
    """Median wall seconds of n calls of fn, each ended by sync, after one
    warm-up call."""
    fn()
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def md_steps_per_sec(system, pos, n, rounds):
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False, seed=1)
    state = [sim.initial_state(pos, n, 0.85)]

    def run():
        state[0] = sim.advance(state[0], rounds)
    t = timed(run, lambda: sync_fetch(state[0].pos))
    if not torch.isfinite(state[0].pos).all():
        raise RuntimeError("positions not finite")
    return 3 * rounds * n / t


class CountOps(TorchDispatchMode):
    """The aten operations dispatched inside, views left out."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))



def is_annotation(event):
    """A span's annotation in a profile (`tracing.is_user_annotation`),
    not device work; a tree without the recorder has none."""
    try:
        from upside_md_torch.tracing import is_user_annotation
    except ImportError:
        return False
    return is_user_annotation(event)


def launches_per_eval(system, pos, n=64):
    """(device kernels and copies, dispatched ops) of one warm deriv."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = pos[None].repeat(n, 1, 1)
    _, _, cache = system.deriv(x)
    system.deriv(x, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.deriv(x, cache)
        torch.cuda.synchronize()
    dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
              and not is_annotation(e))
    with CountOps() as ops:
        system.deriv(x, cache)
    torch.cuda.synchronize()
    return {"device_events": dev or None, "ops": sum(ops.n.values())}


def cuda_ms(fn, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def perturbed(pos, n, seed=0):
    rng = np.random.default_rng(seed)
    p0 = pos.cpu().numpy()
    return torch.as_tensor(
        p0[None] + 0.02 * rng.standard_normal((n,) + p0.shape),
        dtype=pos.dtype, device=pos.device)


def cotangent_ms(system, pos, n=64):
    from upside_md_torch.ops.fused_pair import block_table_cotangents
    x = perturbed(pos, n)
    with torch.no_grad():
        outs = system.evaluate(x)[1]
    plan, prep = system.pair_fusion, system.fused_prepared()
    x1, w1, x2, wcol = plan.block_inputs(system.consts, outs)
    tabs = plan.tables(system.params)
    gen = torch.Generator(device=x.device).manual_seed(3)
    g_cov = torch.randn((n, 2, prep.n2), generator=gen, device=x.device)
    g_grid = torch.randn((n, prep.n2, prep.n2), generator=gen,
                         device=x.device)
    g_env = torch.randn((n, prep.n_e), generator=gen, device=x.device)

    def call(needed):
        return lambda: block_table_cotangents(
            prep, needed, tabs, x1, w1, x2, wcol, g_cov, g_grid, g_env)
    with torch.no_grad():
        return {"rotamer": cuda_ms(call((False, False, True, False))),
                "three spline tables": cuda_ms(call((True, True, True,
                                                      False))),
                "env table": cuda_ms(call((False, False, False, True)))}


def train_seconds(system, params, pos, n=64, K=10):
    import torch.distributed as dist
    from upside_md_torch.parallel.dryrun import free_port
    from upside_md_torch.parallel.mesh import (make_replica_mesh,
                                               sharded_training_step)
    batch = perturbed(pos, n)
    target = torch.zeros(n, dtype=pos.dtype, device=pos.device)

    def sgd(p, grads, opt_state):
        return ({nm: {k: v - 1e-6 * grads[nm][k] if k in grads.get(nm, {})
                      else v for k, v in group.items()}
                 for nm, group in p.items()}, opt_state)

    mesh = make_replica_mesh(1, 0, system.device,
                             init_method=f"tcp://localhost:{free_port()}")
    try:
        step = sharded_training_step(system, sgd, mesh)
        out = [None]

        def one():
            out[0] = step(params, (), batch, target)[2]
        t_one = timed(one, lambda: sync_fetch(out[0]))

        def chained():
            p, acc = params, torch.zeros((), device=pos.device)
            for _ in range(K):
                p, _, loss = step(p, (), batch, target)
                acc = acc + loss
            out[0] = acc
        t_dev = timed(chained, lambda: sync_fetch(out[0])) / K
    finally:
        if dist.is_initialized():
            mesh.close()
    return {"s_a_step_chained": t_dev, "s_one_step": t_one}


# ---------------------------------------------------------------------------
# the forms of backbone_pairs' sums (--forms)
# ---------------------------------------------------------------------------

def _pair_values(c, affine_in, r2_by_components):
    """The node's masked (B, 4R, 4R) pair values (nodes/steric.py)."""
    from upside_md_torch.nodes import steric
    affine = affine_in[:, c["id"]]
    R = steric.quat_to_rot(affine[..., 3:7])
    atoms = steric.rotate_vec(R.unsqueeze(-3), c["ref_pos"]) \
        + affine[..., None, 0:3]
    ax = atoms.reshape(atoms.shape[0], -1, 3)
    d = ax.unsqueeze(1) - ax.unsqueeze(2)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2] if r2_by_components else (d * d).sum(-1)
    v, _ = steric.compact_sigmoid(r2 - steric.WALL2, steric.SHARPNESS)
    return torch.where(c["pair_mask"], v, torch.zeros_like(v))


def _halving_autograd(x):
    """An earlier halving sum, differentiated by autograd."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


class _FlatPadded(torch.autograd.Function):
    """An earlier halving: the whole flattened grid zero-padded to a power
    of two, then halved; the sum's broadcast backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = n = x.shape[-1]
        width = 1 << max(n - 1, 0).bit_length()
        x = torch.nn.functional.pad(x, (0, width - n))
        while width > 1:
            width //= 2
            x = x[..., :width] + x[..., width:]
        return x[..., 0]

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(*g.shape, ctx.n)


def _forms():
    from upside_md_torch.nodes import steric
    scale = steric.ENERGY_SCALE
    return {
        "parent: (d*d).sum(-1), .sum((-1, -2))":
            lambda c, a: scale * _pair_values(c, a, False).sum((-1, -2)),
        "r2 by components, two autograd halvings":
            lambda c, a: scale * _halving_autograd(_halving_autograd(
                _pair_values(c, a, True))),
        "r2 by components, one padded halving":
            lambda c, a: scale * _FlatPadded.apply(
                _pair_values(c, a, True).flatten(-2)),
        "current node": lambda c, a: steric._backbone_pairs(c, {}, [a],
                                                            None),
    }


def time_forms(label):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for bundle_name in ("ubiquitin_full_synth", "trp_cage_full_synth",
                        "cytochrome_c_full_synth"):
        system, pos = System.from_bundle(
            os.path.join(DATA_DIR, bundle_name + ".npz"), "cuda")
        spec = system.by_name["backbone_pairs"]
        c = system.consts["backbone_pairs"]
        with torch.no_grad():
            outs = system.evaluate(perturbed(pos, 64))[1]
        a64 = outs[spec.args[0]]
        for name, form in _forms().items():
            with torch.no_grad():
                whole = form(c, a64)
                parts = torch.cat([form(c, a64[i:i + 16])
                                   for i in range(0, 64, 16)])
            rec = {"batch 64 vs 4 x 16 bitwise": bool(torch.equal(whole,
                                                                  parts)),
                   "max abs diff": float((whole - parts).abs().max())}
            for n in REPLICAS:
                a = a64.repeat(n // 64, 1, 1).requires_grad_(True)

                def call():
                    (g,) = torch.autograd.grad(form(c, a).sum(), a)
                    return g
                rec[f"device ms {n}"] = cuda_ms(call, reps=10)
                rec[f"wall ms {n}"] = 1e3 * timed(
                    call, torch.cuda.synchronize, n=10)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    call()
                    torch.cuda.synchronize()
                rec[f"launches {n}"] = sum(
                    1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not is_annotation(e)) or None
            out[f"{bundle_name}: {name}"] = rec
            print(f"[{label}] {bundle_name}: {name}: {rec}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--cotangents", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("time_fixed_order: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    t0 = time.perf_counter()
    if args.forms:
        rec = {"label": args.label, "card": card,
               "forms": time_forms(args.label)}
        rec["seconds"] = time.perf_counter() - t0
        return emit(rec, args.out)
    if args.cotangents:
        ubq, ubq_pos = System.from_bundle(
            os.path.join(DATA_DIR, "ubiquitin_full_synth.npz"), "cuda")
        rec = {"label": args.label, "card": card,
               "cotangent_ms": cotangent_ms(ubq, ubq_pos),
               "train_s": train_seconds(ubq, ubq.params, ubq_pos)}
        rec["seconds"] = time.perf_counter() - t0
        return emit(rec, args.out)
    bb = {nm: bench_systems.build_backbone_system(seq=seq, device="cuda")
          for nm, seq in (("config1 trp_cage", bench_systems.TRP_CAGE),
                          ("config1 ubiquitin", bench_systems.UBIQUITIN))}
    ubq, ubq_pos = System.from_bundle(
        os.path.join(DATA_DIR, "ubiquitin_full_synth.npz"), "cuda")
    rec = {"label": args.label, "card": card, "md": {}, "launches": {}}
    for nm, (system, pos) in (("config1 trp_cage", bb["config1 trp_cage"]
                               [::2]),
                              ("full ubiquitin", (ubq, ubq_pos))):
        for n in REPLICAS:
            rec["md"][f"{nm} {n}"] = md_steps_per_sec(system, pos, n,
                                                      args.rounds)
            print(f"[{args.label}] md {nm} {n}: "
                  f"{rec['md'][f'{nm} {n}']:.1f} steps/s", flush=True)
    for nm, (system, pos) in (("config1 trp_cage", bb["config1 trp_cage"]
                               [::2]),
                              ("config1 ubiquitin", bb["config1 ubiquitin"]
                               [::2]),
                              ("full ubiquitin", (ubq, ubq_pos))):
        rec["launches"][nm] = launches_per_eval(system, pos)
    rec["cotangent_ms"] = cotangent_ms(ubq, ubq_pos)
    rec["train_s"] = train_seconds(ubq, ubq.params, ubq_pos)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec, args.out)


def emit(rec, out):
    line = json.dumps(rec)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
