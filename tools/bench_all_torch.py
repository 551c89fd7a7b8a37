#!/usr/bin/env python3
"""Every BASELINE configuration and the one-card replica scaling curve, in
one run of the port on an NVIDIA GPU (counterpart of tools/bench_all.py).

    python3 tools/bench_all_torch.py [--device cuda|cpu] [--out FILE]

Prints the card's name and power limit, then a table, a row at a time:

  1. config 1: backbone-only ubiquitin and trp-cage (`bench_systems.
     build_backbone_system`);
  2. full-force-field trp-cage, and config 3: protein G on the 10 Å
     family (`build_10A_system`);
  3. full-force-field ubiquitin at each replica count of the curve;
  4. temperature replica exchange of ubiquitin, the swaps included;
  5. config 4: Hamiltonian replica exchange on cytochrome c, a ±1% ladder
     on the first spring node's spring_const;
  6. config 5: chi1 prediction latency (one evaluation and the coverage
     sensitivities), one-shot and device-bound;
  7. the data-parallel training step (`parallel.mesh`) on a 64-replica
     batch of perturbed ubiquitin conformations.

The full-force-field systems of trp-cage, ubiquitin and cytochrome c are
`entry.full_system`'s: the reference's libraries when present, otherwise
the committed bundles (synthetic libraries, smooth Rama maps).  Timing is
bench.py's: each timed call ends in `torch.cuda.synchronize()` and a host
fetch, the median of three after a warm-up call.  A failing row prints
ERROR and its traceback and the rows after it still run; the script then
exits 1, so a failure cannot pass as a table.  `tools/projection.py` (a
projection to a TPU slice) has no counterpart.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from upside_md_torch import bench_systems  # noqa: E402
from upside_md_torch.bench_systems import (CYT_C, PROTEIN_G,  # noqa: E402
                                           TRP_CAGE, UBIQUITIN)
from upside_md_torch.entry import full_system  # noqa: E402
from upside_md_torch.md.replica import (ReplicaExchange,  # noqa: E402
                                        even_odd_swap_sets)
from upside_md_torch.md.sim import (Simulation, param_axes,  # noqa: E402
                                    stack_param_ensembles)
from upside_md_torch.system import System  # noqa: E402

CURVE = (8, 32, 64, 128, 256, 384, 512, 768, 1024)
REX_EVERY = 10      # rounds between exchange rounds


def timed(fn, sync, n=3):
    """Median wall seconds of n calls of fn, each ended by sync (a device
    synchronisation and a host fetch), after one warm-up call."""
    fn()
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def fetch(t):
    """The hard sync of a timed call: the device's queue, then a host
    fetch of t."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.sum())


def _seed(seed):
    return seed if seed is not None else int(time.time()) % 100000


def md_steps_per_sec(system, params, pos, n_replica, n_rounds=20,
                     seed=None):
    """Aggregate force evaluations a second of `Simulation.advance` over
    n_replica replicas, n_rounds rounds a timed call."""
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False, seed=_seed(seed))
    state = [sim.initial_state(pos, n_replica, 0.85)]

    def step():
        state[0] = sim.advance(state[0], n_rounds, params)

    t = timed(step, lambda: fetch(state[0].pos))
    return 3 * n_rounds * n_replica / t


def acceptance(stats):
    """Swap acceptance over every set's pairs: successes over attempts
    (bench_all.py:96-99)."""
    acc = [s.cpu().numpy() for s in stats]
    return (sum(a[:, 0].sum() for a in acc)
            / max(sum(a[:, 1].sum() for a in acc), 1))


def _exchange_chunk(sim, state, params, spec, rex, beta, n_rounds_total,
                    rex_every, slot_independent):
    """The timed call of the exchange rows: n_rounds_total rounds, an
    exchange round every rex_every, the warm-start cache travelling with
    the configurations.  state: [SimState]; returns the chunk and the
    [replica_index, stats] it updates."""
    energy_of = sim.energy_fn(params)
    B = state[0].pos.shape[0]
    carried = [torch.arange(B, device=state[0].pos.device), None]

    def chunk():
        for _ in range(n_rounds_total // rex_every):
            state[0] = sim.advance(state[0], rex_every, params, spec)
            pos, carried[0], carried[1], _, cache = rex.attempt_swaps(
                state[0].pos, carried[0], beta, energy_of, carried[1],
                slot_independent=slot_independent, aux=state[0].cache,
                generator=sim.generator)
            state[0] = replace(state[0], pos=pos, cache=cache)
    return chunk, carried


def rex_steps_per_sec(system, params, pos, n_replica=64, n_rounds_total=60,
                      rex_every=REX_EVERY, seed=None):
    """End-to-end temperature replica exchange: MD rounds and exchange
    rounds (one ensemble energy evaluation an exchange round; with one
    Hamiltonian the swapped energies are a permutation) in the timing.
    Returns (steps/s, swap acceptance)."""
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False, seed=_seed(seed))
    temps = 0.80 * (1.02 ** np.arange(n_replica))
    state = [sim.initial_state(pos, n_replica, temps)]
    rex = ReplicaExchange(even_odd_swap_sets(n_replica), n_replica)
    beta = torch.as_tensor(1.0 / temps, dtype=system.dtype,
                           device=system.device)
    chunk, carried = _exchange_chunk(sim, state, params, None, rex, beta,
                                     n_rounds_total, rex_every, True)
    t = timed(chunk, lambda: fetch(state[0].pos))
    return 3 * n_rounds_total * n_replica / t, float(acceptance(carried[1]))


def hamiltonian_rex_steps_per_sec(n_replica=64, n_rounds_total=60,
                                  rex_every=REX_EVERY, device="cuda",
                                  seed=None):
    """BASELINE config 4: Hamiltonian replica exchange of n_replica slots
    on 104-residue cytochrome c, full force field, each slot's first
    spring node's spring_const scaled across a 2%-wide ladder (±1%).
    Only that leaf is stacked (`stack_param_ensembles`; `param_axes`
    shows it), so the shared tables keep one kernel launch for all
    replicas; each swap set re-evaluates its swapped configurations under
    the slots' own parameters.  Returns (steps/s, swap acceptance)."""
    system, params, pos, _ = full_system(CYT_C, device)
    vary = [k for k in params if "spring" in k
            and "spring_const" in params[k]][0]
    per_slot = []
    for i in range(n_replica):
        p = {k: dict(v) for k, v in params.items()}
        p[vary]["spring_const"] = params[vary]["spring_const"] * \
            (1.0 + 0.02 * (i / max(n_replica - 1, 1) - 0.5))
        per_slot.append(p)
    mixed, spec = stack_param_ensembles(per_slot)
    axes = param_axes(mixed, spec)
    stacked = {(n, k) for n, leaves in axes.items()
               for k, a in leaves.items() if a == 0}
    if stacked != {(vary, "spring_const")}:
        raise AssertionError(f"the ladder stacked {sorted(stacked)}")

    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False, seed=_seed(seed))
    temps = 0.80 * (1.02 ** np.arange(n_replica))
    state = [sim.initial_state(pos, n_replica, temps)]
    rex = ReplicaExchange(even_odd_swap_sets(n_replica), n_replica)
    beta = torch.as_tensor(1.0 / temps, dtype=system.dtype,
                           device=system.device)
    chunk, carried = _exchange_chunk(sim, state, mixed, spec, rex, beta,
                                     n_rounds_total, rex_every, False)
    t = timed(chunk, lambda: fetch(state[0].pos))
    return 3 * n_rounds_total * n_replica / t, float(acceptance(carried[1]))


def chi1_latency(device="cuda", seq=UBIQUITIN, K=30, n_total=5):
    """Config 5: chi1 prediction latency on `seq` (the prediction config
    of predict_chi1: no springs or sterics, loose hbond criteria, dynamic
    rotamer 1-body, hbond energy -1e-5; the reference's sidechain library
    when present, else `data/libs/sidechain_synth.h5`).

    Returns (t_dev, t_total): t_total the wall seconds of one prediction
    (one evaluation and the hbond_coverage sensitivities) ended by a host
    fetch, the median of n_total; t_dev those of K chained evaluations
    over one sync, each perturbing the positions by a value of the last
    output so that none can be skipped, divided by K."""
    from upside_md_torch.config.builder import ConfigBuilder
    lib = bench_systems.SIDECHAIN if bench_systems.have_reference_params() \
        else bench_systems.SIDECHAIN_SYNTH
    b = ConfigBuilder(f">x\n{seq}\n", seed=7)
    b.add_rotamer_sidechains(lib, lib, damping=0.4, dynamic_1body=True)
    b.add_hbond(hbond_energy=-1e-5, loose=True, coverage_library=lib)
    b.add_rotamer_node()
    with tempfile.TemporaryDirectory() as tmp:
        system, pos = System.from_up(b.write(os.path.join(tmp, "chi1.up")),
                                     device)
    x = pos[None]
    out = [None]

    def run():
        out[0] = system.get_sens(x, "hbond_coverage")

    t_total = timed(run, lambda: fetch(out[0]), n=n_total)
    res = [None]

    def run_chained():
        p, acc = x, torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(K):
            s = system.get_sens(p, "hbond_coverage").sum()
            p, acc = p + 1e-9 * s * torch.sign(p), acc + s
        res[0] = acc

    t_dev = timed(run_chained, lambda: fetch(res[0]), n=3) / K
    return t_dev, t_total


@contextlib.contextmanager
def one_rank_mesh(device):
    """A replica mesh of one rank on `device` (a process group on a free
    local port), closed after; an existing process group is used as it
    is and left open."""
    import torch.distributed as dist
    from upside_md_torch.parallel.dryrun import free_port
    from upside_md_torch.parallel.mesh import make_replica_mesh
    own = not dist.is_initialized()
    mesh = make_replica_mesh(1, 0, device,
                             init_method=f"tcp://localhost:{free_port()}")
    try:
        yield mesh
    finally:
        if own:
            mesh.close()


def training_throughput(n_replica=64, K=10, device="cuda", seq=UBIQUITIN):
    """The differentiable-training step: the energy-match loss over a batch
    of n_replica perturbed conformations of `seq` (full force field),
    every floating parameter's gradient (the table cotangents included),
    an SGD update, through `parallel.mesh.sharded_training_step` on a
    mesh of one rank.  Returns (t_dev, t_total): seconds a step over K
    chained steps a sync (the parameters evolve through each update), and
    one step's wall time."""
    from upside_md_torch.parallel.mesh import sharded_training_step
    system, params, pos, _ = full_system(seq, device)
    rng = np.random.default_rng(0)
    p0 = pos.cpu().numpy()
    batch = torch.as_tensor(
        p0[None] + 0.02 * rng.standard_normal((n_replica,) + p0.shape),
        dtype=pos.dtype, device=pos.device)
    target = torch.zeros(n_replica, dtype=pos.dtype, device=pos.device)

    def sgd(p, grads, opt_state):
        return ({n: {k: v - 1e-6 * grads[n][k] if k in grads.get(n, {})
                     else v for k, v in group.items()}
                 for n, group in p.items()}, opt_state)

    with one_rank_mesh(system.device) as mesh:
        step = sharded_training_step(system, sgd, mesh)
        out = [None]

        def run():
            out[0] = step(params, (), batch, target)[2]

        t_total = timed(run, lambda: fetch(out[0]), n=3)
        res = [None]

        def run_chained():
            p, acc = params, torch.zeros((), dtype=pos.dtype,
                                         device=pos.device)
            for _ in range(K):
                p, _, loss = step(p, (), batch, target)
                acc = acc + loss
            res[0] = acc

        t_dev = timed(run_chained, lambda: fetch(res[0]), n=3) / K
    return t_dev, t_total


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "device: cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
        else f"nvidia-smi failed: {r.stderr.strip()}"


def run_rows(device="cuda", rounds=20, rex_rounds=60, replicas=64,
             train_steps=10, curve=CURVE):
    """Run the table's rows in bench_all.py's order, printing each as it
    completes.  Returns the rows: {"row", "value", "unit", and "error"
    (a traceback) when it failed, or extras such as "acceptance"}."""
    rows = []

    def row(name, fn, unit="steps/s"):
        try:
            out = fn()
        except Exception:
            print(f"{name:55s}        ERROR", flush=True)
            err = traceback.format_exc()
            print(err, flush=True)
            rows.append({"row": name, "value": None, "unit": unit,
                         "error": err})
            return
        value, extra = out if isinstance(out, tuple) else (out, {})
        rows.append({"row": name, "value": value, "unit": unit, **extra})
        print(f"{name:55s} {value:12,.2f} {unit}", flush=True)
        for k, v in extra.items():
            print(f"    ({k} {v:.4f})", flush=True)

    def md(build, n):
        system, params, pos, _ = build()
        return md_steps_per_sec(system, params, pos, n, rounds)

    for seq, nm in ((UBIQUITIN, "76-res ubiquitin"),
                    (TRP_CAGE, "20-res Trp-cage")):
        row(f"backbone-only {nm}, {replicas} rep", lambda seq=seq: md(
            lambda: bench_systems.build_backbone_system(seq=seq,
                                                        device=device),
            replicas))
    row(f"full FF 20-res Trp-cage, {replicas} rep",
        lambda: md(lambda: full_system(TRP_CAGE, device), replicas))
    row(f"full FF 56-res protein-G (10A family), {replicas} rep",
        lambda: md(lambda: bench_systems.build_10A_system(
            seq=PROTEIN_G, device=device), replicas))

    ubq = []

    def ubiquitin():
        if not ubq:
            ubq.append(full_system(UBIQUITIN, device))
        return ubq[0]

    for n in curve:
        row(f"full FF 76-res ubiquitin, {n} rep",
            lambda n=n: md(ubiquitin, n))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

    def trex():
        system, params, pos, _ = ubiquitin()
        sps, acc = rex_steps_per_sec(system, params, pos, replicas,
                                     rex_rounds)
        return sps, {"T-rex acceptance": acc}
    row(f"full FF ubiquitin {replicas}-replica T-rex incl. swaps", trex)

    def hrex():
        sps, acc = hamiltonian_rex_steps_per_sec(replicas, rex_rounds,
                                                 device=device)
        return sps, {"H-rex acceptance": acc}
    row(f"full FF 104-res cyt-c {replicas}-replica H-rex incl. swaps", hrex)

    def chi1():
        t_dev, t_total = chi1_latency(device)
        return t_dev * 1e3, {"one-shot ms": t_total * 1e3}
    row("chi1 prediction, 76-res, ms a chained evaluation", chi1, "ms")

    def train():
        t_dev, t_total = training_throughput(replicas, train_steps, device)
        return t_dev * 1e3, {"one-shot ms": t_total * 1e3}
    row(f"training step, {replicas}-rep batch, ms a chained step", train,
        "ms")
    return rows


def main(argv=None):
    """The whole table at bench_all.py's sizes (`run_rows`' defaults)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("bench_all_torch: no CUDA device; pass "
                           "--device cpu")
    print(card_line(args.device), flush=True)
    rows = run_rows(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line(args.device), "rows": rows}, f,
                      indent=1)
    failed = [r["row"] for r in rows if "error" in r]
    if failed:
        print(f"{len(failed)} rows failed: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
