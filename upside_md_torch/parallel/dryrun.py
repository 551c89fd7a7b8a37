"""The multi-rank dry run (counterpart of `dryrun_multichip` in the JAX
package's __graft_entry__.py).

    python -m upside_md_torch.parallel.dryrun --ranks N [--device cuda|cpu]
        [--backend nccl|gloo] [--replicas R]

spawns N ranks (`torch.multiprocessing.spawn`, a process group over a
local TCP port).  Each rank builds the full ubiquitin force field with
`bench_systems.build_full_system` (rotamer BP, hbond coverage, the
environment chain; never a backbone-only fallback) and runs the five
steps of the JAX dry run on 2 N replicas (or R):

1. one sharded round (`sharded_advance`);
2. a replica exchange across ranks (`sharded_attempt_swaps`);
3. one data-parallel training step (`sharded_training_step`);
4. one round of a Hamiltonian ensemble, the first spring node's
   spring_const scaled by 1 + 0.01 i in slot i
   (`sharded_hamiltonian_advance`);
5. the audit: no collective counted inside either sharded advance, and on
   a card no profiled event whose name holds "nccl" or "gloo" inside
   either advance's window.

Rank r runs on cuda:r mod the card count (ranks that share a card need
`--backend gloo`) or on the CPU.  Any rank's failure makes the command
exit non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

from ..tracing import is_user_annotation
from . import mesh as M

DT, THERMOSTAT_INTERVAL = 0.009, 0.027


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def audited(label, mesh, found):
    """Counts the collectives issued inside the block and, on a card,
    profiles it; appends what was found to `found`."""
    before = dict(M.COLLECTIVES)
    on_card = mesh.device.type == "cuda"
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    with prof:
        yield
        if on_card:
            torch.cuda.synchronize(mesh.device)
    comm = sorted({e.name for e in prof.events()
                   if not is_user_annotation(e)
                   and ("nccl" in e.name.lower()
                        or "gloo" in e.name.lower())}) if on_card else []
    found.append({"advance": label,
                  "collectives": sum(M.COLLECTIVES[k] - before[k]
                                     for k in before),
                  "comm_events": comm})


def spring_ladder(params, n):
    """(params, spec) of n slots: the first spring node's spring_const
    scaled by 1 + 0.01 i in slot i, stacked (__graft_entry__.py:146-167)."""
    from ..md.sim import stack_param_ensembles
    spring = [k for k in params if "spring_const" in params[k]][0]
    slots = []
    for i in range(n):
        p = {k: dict(v) for k, v in params.items()}
        p[spring]["spring_const"] = params[spring]["spring_const"] * \
            (1.0 + 0.01 * i)
        slots.append(p)
    return stack_param_ensembles(slots)


def dryrun_rank(mesh, system, params, pos, n_replica):
    """The five steps on this rank; raises if one fails.  Returns what it
    measured."""
    from ..md.replica import ReplicaExchange, even_odd_swap_sets
    from ..md.sim import Simulation
    t0 = time.perf_counter()
    names = {s.node_type.name for s in system.specs}
    if not {"rotamer", "protein_hbond"} <= names:
        raise AssertionError("the dry run expects the full force field")
    sim = Simulation(system, dt=DT, thermostat_interval=THERMOSTAT_INTERVAL,
                     do_recenter=False, seed=3)
    temps = 0.8 + 0.05 * np.arange(n_replica)
    state = M.shard_replica_state(
        sim.initial_state(pos, n_replica, temps), mesh)
    audit = []

    # 1. one sharded round
    advance = M.sharded_advance(sim, mesh, 1)
    with audited("sharded advance", mesh, audit):
        state = advance(state, params)
    if not torch.isfinite(state.pos).all():
        raise AssertionError("sharded advance: positions not finite")

    # 2. replica exchange across the ranks
    rex = ReplicaExchange(even_odd_swap_sets(n_replica), n_replica)
    beta = torch.as_tensor(1.0 / temps, dtype=state.pos.dtype,
                           device=mesh.device)
    state, idx, stats, energies = M.sharded_attempt_swaps(
        mesh, rex, state, torch.arange(n_replica, device=mesh.device), beta,
        sim.energy_fn(params), slot_independent=True,
        generator=sim.generator)
    if sorted(idx.tolist()) != list(range(n_replica)):
        raise AssertionError(f"replica_index {idx.tolist()} is not a "
                             "permutation")

    # 3. one data-parallel training step on the exchanged positions
    def sgd(p, grads, opt_state):
        return ({n: {k: v - 1e-4 * grads[n][k] if k in grads.get(n, {})
                     else v for k, v in group.items()}
                 for n, group in p.items()}, opt_state)

    step = M.sharded_training_step(system, sgd, mesh)
    batch = mesh.all_gather(state.pos)
    target = torch.zeros(n_replica, dtype=batch.dtype, device=mesh.device)
    new_params, _, loss = step(params, (), batch, target)
    if not torch.isfinite(loss):
        raise AssertionError(f"training step: loss {loss.item()}")
    if not all(torch.isfinite(v).all() for g in new_params.values()
               for v in g.values() if v.is_floating_point()):
        raise AssertionError("training step: parameters not finite")

    # 4. a Hamiltonian ensemble: the spring ladder, its stacked leaves cut
    # to the rank's slots, the shared tables whole
    mixed, spec = spring_ladder(params, n_replica)
    if not spec:
        raise AssertionError("the ladder stacked no leaf")
    sim_h = Simulation(system, dt=DT, thermostat_interval=THERMOSTAT_INTERVAL,
                       do_recenter=False, seed=7)
    h_state = M.shard_replica_state(
        sim_h.initial_state(pos, n_replica, temps), mesh)
    h_advance, _ = M.sharded_hamiltonian_advance(sim_h, mesh, 1, mixed, spec)
    with audited("sharded Hamiltonian advance", mesh, audit):
        h_state = h_advance(h_state)
    if not torch.isfinite(h_state.pos).all():
        raise AssertionError("Hamiltonian advance: positions not finite")

    # 5. the audit: the ranks share nothing inside an advance
    for a in audit:
        if a["collectives"] or a["comm_events"]:
            raise AssertionError(f"{a['advance']}: {a['collectives']} "
                                 f"collectives, events {a['comm_events']} "
                                 "inside the advance")
    return {"rank": mesh.rank, "replicas": n_replica,
            "local_replicas": state.pos.shape[0], "audit": audit,
            "swaps": torch.cat(stats).sum(0).tolist(),
            "energies_finite": bool(torch.isfinite(energies).all()),
            "loss": loss.item(), "collectives": dict(M.COLLECTIVES),
            "seconds": time.perf_counter() - t0}


def rank_main(rank, world_size, init_method, device, backend, n_replica,
              out_dir):
    """One spawned rank: the mesh, the full ubiquitin force field, the dry
    run; its result as JSON in out_dir/rank<r>.json."""
    from .. import bench_systems
    from ..ops import kernels
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    mesh = M.make_replica_mesh(world_size, rank, device, backend,
                               init_method)
    try:
        system, params, pos, _ = bench_systems.build_full_system(
            device=mesh.device)
        kernels.reset_counts()
        out = dryrun_rank(mesh, system, params, pos, n_replica)
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["device"] = str(mesh.device)
        out["backend"] = mesh.backend
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.close()


def run(ranks, device="cuda", backend=None, replicas=None):
    """Spawn the ranks and wait for them; returns their results by rank.
    Raises if a rank failed."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        backend = backend or "nccl"
        if backend == "nccl" and ranks > torch.cuda.device_count():
            raise ValueError(f"{ranks} NCCL ranks on "
                             f"{torch.cuda.device_count()} cards: NCCL "
                             "refuses two ranks on one card; pass "
                             "--backend gloo")
    n_replica = replicas or 2 * ranks
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(
            rank_main, (ranks, f"tcp://localhost:{free_port()}", device,
                        backend, n_replica, out_dir), nprocs=ranks)
        results = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--replicas", type=int, default=None)
    args = ap.parse_args(argv)
    results = run(args.ranks, args.device, args.backend, args.replicas)
    for r in results:
        print(json.dumps(r), flush=True)
    print(f"dry run ok: {args.ranks} ranks, {results[0]['replicas']} "
          f"replicas, {results[0]['backend']} on {args.device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
