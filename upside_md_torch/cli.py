"""The `upside` command line (port of upside_md_tpu/cli.py; reference
src/main.cpp:317-752).

    python -m upside_md_torch.cli A.up|A.npz [B.up|B.npz ...] --duration T
        --frame-interval F [--temperature 0.8,0.9,...]
        [--replica-interval R --swap-set 0-1,2-3 ...]
        [--monte-carlo-interval M] [--anneal-factor A]
        [--log-level basic|detailed|extensive] [--set-param P.h5]
        [--potential-deriv-agreement] [--initial-structures S.pkl]
        [--output-dir DIR] [--device cuda|cpu]

The JAX command line's flags and run semantics: durations and intervals
in simulation time become whole rounds of 3 dt, one temperature a slot,
sqrt-space annealing, pivot and jump MC from the first configuration's
move tables, Hamiltonian or temperature replica exchange over swap sets,
per-frame logging at the chosen level and the closing throughput,
equipartition and acceptance report.  A configuration is a `.up` file
(read by `config/reader.py`, no h5py needed) or a spec bundle (`.npz`),
mixed as the user likes; every configuration named is one replica slot, a
configuration named several times is loaded once, and slots whose
parameters differ run as a Hamiltonian ensemble
(`md.sim.stack_param_ensembles`).  The run is on the card unless
`--device cpu`.

One difference: each slot's frames go to a file of its own,
`<output dir>/<config stem>_<slot>.h5` (`io/logger.py`), with the
configuration's sequence in /input where it has one, where the JAX
command line writes into the `.up` configuration's /output; the port
never writes to a configuration.  The files are HDF5 written by
`io/h5.py`, with the JAX logger's /output datasets, and need no h5py.

`run_ensemble` is the loop: it advances the ensemble to each frame or
exchange round, recentres and evaluates the frame's potential, streams
and hbond count at frames, hands them to a callback (the logger's, here),
attempts replica exchange at exchange rounds, each slot keeping its own
Hamiltonian, and asks a stop hook after each chunk (SIGINT and SIGTERM
stop the run after the current chunk, flush every file and re-raise).
"""

from __future__ import annotations

import argparse
import os
import pickle
import signal
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from .config import load
from .io.logger import LOG_LEVELS, H5Logger
from .io.streams import make_frame_fn
from .md.mc import JumpSampler, PivotSampler
from .md.replica import ReplicaExchange, parse_swap_sets
from .md.sim import Simulation, stack_param_ensembles
from .system import System


def event_rounds(start, n_round, frame_interval, replica_interval=0):
    """The rounds at which the loop stops, as (round, is_frame,
    is_exchange), from `start` up to `n_round` (cli.py:253-263)."""
    events, done = [], start
    while done < n_round:
        target = min(done + frame_interval, n_round)
        if replica_interval:
            target = min(target, (done // replica_interval + 1)
                         * replica_interval)
        done = target
        events.append((done, done % frame_interval == 0 or done == n_round,
                       bool(replica_interval)
                       and done % replica_interval == 0))
    return events


def _frame(sim, state, params, frame_fn, replica_index, rex_stats, last_mc,
           done):
    """One frame's values as numpy arrays (cli.py:265-344): positions,
    potential per slot at the force-evaluation counter 3 * done
    (cli.py:269), the streams and hbond count of the same evaluation,
    kinetic energy, temperature, replica index, the cumulative swaps, the
    MC stats since the last frame, each rotamer node's BP health, and the
    console line."""
    system = sim.system
    pot, streams, hb = frame_fn(state.pos, params, 3 * done)
    frame = {"pos": state.pos, "potential": pot,
             "kinetic": sim.kinetic_energy(state),
             "temperature": state.temperature,
             "replica_index": replica_index}
    if hb is not None:
        frame["hbonds"] = hb
    if rex_stats is not None:
        # (n_swap_pairs, 2) across all sets (main.cpp:211-218)
        frame["replica_cumulative_swaps"] = torch.cat(rex_stats)
    for kind, sampler in (("pivot", sim.pivot_sampler),
                          ("jump", sim.jump_sampler)):
        if sampler is None:
            continue
        cur = getattr(state, kind + "_stats")
        # per-frame stats with reset semantics (monte_carlo_sampler.h:
        # 28-37)
        frame[kind + "_stats"] = cur - last_mc.get(kind, torch.zeros_like(
            cur))
        last_mc[kind] = cur
    for name, entry in state.cache.items():
        if system.by_name[name].node_type.name != "rotamer":
            continue
        tol = system.by_name[name].consts.get("tol", 1e-3)
        frame[name + "_n_bad_solve"] = (entry["dev"] > tol).to(torch.int32)
        frame[name + "_solve_iters"] = entry["iters"]
    out = {k: v.detach().cpu().numpy() for k, v in frame.items()}
    out["streams"] = {k: v.detach().cpu().numpy()
                      for k, v in streams.items()}
    x = out["pos"][0]
    rg = np.sqrt(((x - x.mean(0)) ** 2).sum(-1).mean())
    hb_txt = f"{float(out['hbonds'][0]):5.1f} hbonds, " if hb is not None \
        else ""
    out["console"] = (f"{done * 3 * sim.dt:.0f} / {sim.duration:.0f} temp "
                      f"{float(out['temperature'][0]):.2f} {hb_txt}Rg "
                      f"{rg:5.1f} A, potential {out['potential'][0]: 8.2f}")
    return out


def run_ensemble(sim, state, params, spec, n_round, rex=None,
                 replica_interval=0, beta=None, frame_callback=None,
                 log_level=None, stop=None):
    """Run the ensemble from its round number up to round `n_round`.

    params, spec: the slots' parameters and the stacked leaves
    (`md.sim.stack_param_ensembles`; the system's own and an empty spec
    for one shared Hamiltonian).  rex: a `ReplicaExchange`, attempted
    every `replica_interval` rounds with inverse temperatures `beta` (the
    slots' initial temperatures' by default); with shared parameters the
    swaps only permute the energies (`slot_independent`).  Frames come
    every `sim.frame_interval` rounds and at the end: the state is
    recentred there (if `sim.do_recenter`), the graph evaluated once for
    the potential, the streams of `log_level` (`io/streams.py`; None for
    none) and the hbond count, and `frame_callback(round, values)`
    receives `_frame`'s values.  `stop()`, asked after each chunk, ends
    the run there with a frame, before that round's exchange.

    Returns (state, summary): the final `replica_index`, the swap stats
    per pair per set, the energies carried by the last exchange round,
    the energy-only evaluations of the frames and exchanges, the frames'
    kinetic energies, the wall time and whether `stop` ended the run."""
    hamiltonian = bool(spec)
    B = state.pos.shape[0]
    dev = state.pos.device
    replica_index = torch.arange(B, device=dev)
    if beta is None:
        beta = 1.0 / state.initial_temperature
    energy_of = sim.energy_fn(params)
    frame_fn, _ = make_frame_fn(sim.system, log_level)
    rex_stats = energies = None
    n_energy_evals = 0
    last_mc, kinetic = {}, []
    stopped = False
    t_start = time.perf_counter()
    start = done = state.round_num
    for target, is_frame, is_exchange in event_rounds(
            start, n_round, sim.frame_interval, replica_interval):
        state = sim.advance(state, target - done, params, spec)
        done = target
        stopped = stop is not None and bool(stop())
        if is_frame or stopped:
            if sim.do_recenter:
                state = sim.recentered(state)
            values = _frame(sim, state, params, frame_fn, replica_index,
                            rex_stats, last_mc, done)
            n_energy_evals += 1
            kinetic.append(values["kinetic"])
            if frame_callback is not None:
                frame_callback(done, values)
        if stopped:
            break
        if is_exchange and rex is not None:
            # the solver warm-start cache swaps WITH the configurations
            pos, replica_index, rex_stats, energies, cache = \
                rex.attempt_swaps(state.pos, replica_index, beta, energy_of,
                                  rex_stats, slot_independent=not hamiltonian,
                                  aux=state.cache, generator=sim.generator)
            n_energy_evals += 1 + (0 if not hamiltonian
                                   else len(rex.swap_sets))
            state = replace(state, pos=pos, cache=cache)
    if state.pos.is_cuda:
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_start
    steps = 3 * (done - start)
    print(f"\nfinished in {elapsed:.1f} seconds "
          f"({elapsed * 1e6 / max(B, 1) / max(steps, 1):.2f} "
          f"us/system/step, "
          f"{steps * sim.dt / elapsed * 3600:.1e} "
          f"simulation_time_unit/hour)", flush=True)
    if kinetic:
        # equipartition over the last half of the frames (cli.py:352-360)
        kin = np.stack(kinetic)[len(kinetic) // 2:].mean(0)
        temps = state.initial_temperature.cpu().numpy()
        print("avg_kinetic_energy/1.5kT " + " ".join(
            f"{r: .3f}" for r in kin / (1.5 * temps)), flush=True)
    for kind, sampler in (("pivot", sim.pivot_sampler),
                          ("jump", sim.jump_sampler)):
        if sampler is not None:
            s = getattr(state, kind + "_stats").sum(0).cpu().numpy()
            print(f"{kind}_success: {s[0] / max(s[1], 1):.4f}", flush=True)
    return state, {"replica_index": replica_index, "rex_stats": rex_stats,
                   "energies": energies, "n_energy_evals": n_energy_evals,
                   "kinetic": kinetic, "seconds": elapsed,
                   "stopped": stopped}


def potential_deriv_agreement(system, params, pos, eps=1e-3, batch=256):
    """Finite-difference force check (main.cpp:279-315): the relative RMS
    deviation between the autograd gradient at `pos` (n_atom, 3) and
    central differences of step `eps`, the shifted configurations
    evaluated `batch` at a time."""
    x = torch.as_tensor(pos, dtype=system.dtype,
                        device=system.device)
    g = system.deriv(x[None], params=params)[0][0].cpu().numpy()
    n = x.numel()
    steps = torch.cat([torch.eye(n, dtype=x.dtype, device=x.device),
                       -torch.eye(n, dtype=x.dtype, device=x.device)]) * eps
    energies = torch.cat([
        system.energy(x[None] + s.reshape(-1, *x.shape), params)
        for s in steps.split(batch)]).double().cpu().numpy()
    fd = ((energies[:n] - energies[n:]) / (2 * eps)).reshape(g.shape)
    num = np.sqrt(np.mean((g - fd) ** 2))
    den = np.sqrt(np.mean(fd ** 2))
    return num / max(den, 1e-12)


def recycle_structures(path, n_replica, n_atom):
    """Load a pickle of one or more structures and recycle them over the
    replica slots (slot i gets structure i mod n_structures) — the
    reference's --initial-structure semantics for replica ensembles
    (upside_config.py:1296-1301 help text; run_upside.py slices the list
    per generated config)."""
    with open(path, "rb") as f:
        structs = np.asarray(pickle.load(f, encoding="latin1"), np.float64)
    if structs.ndim == 3 and structs.shape[-1] == 1:   # (n_atom, 3, 1)
        structs = structs[None, :, :, 0]
    elif structs.ndim == 2:                            # (n_atom, 3)
        structs = structs[None]
    elif structs.ndim == 4 and structs.shape[-1] == 1:
        structs = structs[..., 0]
    if structs.shape[1:] != (n_atom, 3):
        sys.exit(f"{path}: expected structures of shape ({n_atom}, 3), "
                 f"got {structs.shape}")
    return structs[np.arange(n_replica) % structs.shape[0]]


def output_path(output_dir, config, slot):
    """The frame file of replica slot `slot` run from configuration
    `config`."""
    stem = os.path.splitext(os.path.basename(config))[0]
    return os.path.join(output_dir, f"{stem}_{slot}.h5")


def read_param_file(path):
    """{node name: flat parameter array} of a --set-param HDF5 file."""
    from .io import h5
    with h5.File(path) as f:
        return {name: np.asarray(f[name]) for name in f}


def _params_equal(a, b):
    return all(torch.equal(a[n][k], b[n][k]) for n in a for k in a[n])


def parser():
    p = argparse.ArgumentParser(
        description="Upside on the GPU: coarse-grained protein MD")
    p.add_argument("--time-step", type=float, default=0.009)
    p.add_argument("--duration", type=float, required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--temperature", default="1.0",
                   help="comma-separated list (one per config or a single "
                        "value)")
    p.add_argument("--swap-set", action="append", default=[],
                   help="like 0-1,2-3 (non-overlapping within a set)")
    p.add_argument("--anneal-factor", type=float, default=1.0)
    p.add_argument("--anneal-duration", type=float, default=-1.0)
    p.add_argument("--frame-interval", type=float, required=True)
    p.add_argument("--replica-interval", type=float, default=0.0)
    p.add_argument("--monte-carlo-interval", type=float, default=0.0)
    p.add_argument("--thermostat-interval", type=float, default=-1.0)
    p.add_argument("--thermostat-timescale", type=float, default=5.0)
    p.add_argument("--disable-recentering", action="store_true")
    p.add_argument("--disable-z-recentering", action="store_true")
    p.add_argument("--log-level", default="detailed", choices=LOG_LEVELS)
    p.add_argument("--potential-deriv-agreement", action="store_true")
    p.add_argument("--set-param", default="",
                   help="HDF5 file of node-name -> flat parameter arrays to "
                        "override before running (main.cpp:384-395)")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--initial-structures", default="",
                   help="pickle of one or more (n_atom, 3) structures; "
                        "recycled over the replica slots, overriding the "
                        "configurations' stored positions")
    p.add_argument("--output-dir", default=".",
                   help="directory of the per-slot frame files "
                        "<config stem>_<slot>.h5")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu: every kernel's "
                        "plain version)")
    p.add_argument("configs", nargs="+",
                   help=".up configurations or .npz spec bundles, one a "
                        "replica slot")
    return p


def load_configs(configs, device):
    """{path: (System, initial positions (n_atom, 3) tensor, aux)}, each
    distinct configuration (`.up` or `.npz`) loaded once."""
    out = {}
    for c in dict.fromkeys(configs):
        records, pos, aux = load(c)
        out[c] = System.from_records(records, pos, device) + (aux,)
    return out


def load_ensemble(args, loaded=None):
    """The slots' system, parameters (stacked where they differ: the
    Hamiltonian ensemble), stacked leaves, initial positions (B, n_atom,
    3) and slot 0's own parameters, from the parsed command line and
    `load_configs`' result (loaded here when not given):
    --initial-structures and --set-param applied (cli.py:124-164)."""
    if loaded is None:
        loaded = load_configs(args.configs, args.device)
    system = loaded[args.configs[0]][0]
    pos = torch.stack([loaded[c][1] for c in args.configs])
    if args.initial_structures:
        pos = torch.as_tensor(recycle_structures(
            args.initial_structures, len(args.configs), pos.shape[1]),
            dtype=system.dtype, device=system.device)
    distinct = [s for s, _, _ in loaded.values()]
    hamiltonian = any(not _params_equal(system.params, s.params)
                      for s in distinct[1:])
    if args.set_param:
        from .engine import Upside
        overrides = read_param_file(args.set_param)
        for s in (distinct if hamiltonian else distinct[:1]):
            eng = Upside(s, initial_pos=pos[0])
            for node_name, val in overrides.items():
                eng.set_param(val, node_name)
    if hamiltonian:
        params, spec = stack_param_ensembles(
            [loaded[c][0].params for c in args.configs])
    else:
        params, spec = system.params, frozenset()
    return system, params, spec, pos, system.params


def log_values(loggers, t, v):
    """Log one frame's values (`_frame`'s, at simulation time t) into each
    slot's logger, as the JAX logger's datasets and dtypes."""
    for ns, lg in enumerate(loggers):
        lg.log_frame("pos", v["pos"][ns][None].astype(np.float32))
        for name in ("kinetic", "potential", "temperature"):
            lg.log_frame(name, v[name][ns:ns + 1].astype(np.float32))
        lg.log_frame("time", np.float64(t))
        lg.log_frame("replica_index",
                     v["replica_index"][ns:ns + 1].astype(np.int64))
        for name, val in v["streams"].items():
            lg.log_frame(name, val[ns].astype(
                np.float32 if val.dtype.kind == "f" else val.dtype))
        for name in v:
            if name.endswith(("_stats", "_n_bad_solve", "_solve_iters")):
                lg.log_frame(name, v[name][ns].astype(np.int32))
        if "replica_cumulative_swaps" in v:
            lg.log_frame("replica_cumulative_swaps",
                         v["replica_cumulative_swaps"].astype(np.int64))


def main(argv=None):
    args = parser().parse_args(argv)
    dt = args.time_step
    temps = [float(x) for x in args.temperature.split(",")]
    n_sys = len(args.configs)
    if len(temps) == 1:
        temps = temps * n_sys
    if len(temps) != n_sys:
        sys.exit(f"got {len(temps)} temperatures for {n_sys} systems")
    loaded = load_configs(args.configs, args.device)
    system, params, spec, pos, p_first = load_ensemble(args, loaded)

    aux = loaded[args.configs[0]][2]
    pivot = jump = None
    if args.monte_carlo_interval > 0 and "pivot_moves" in aux:
        pm = aux["pivot_moves"]
        pivot = PivotSampler.from_tables(
            pm["pivot_atom"], pm["pivot_range"], pm["pivot_restype"],
            pm["proposal_pot"], device=args.device)
    if args.monte_carlo_interval > 0 and "jump_moves" in aux:
        jm = aux["jump_moves"]
        jump = JumpSampler.from_tables(jm["atom_range"], jm["sigma_trans"],
                                       jm["sigma_rot"], device=args.device)

    sim = Simulation(
        system, dt=dt, duration=args.duration,
        thermostat_timescale=args.thermostat_timescale,
        thermostat_interval=(args.thermostat_interval
                             if args.thermostat_interval > 0 else None),
        frame_interval=args.frame_interval,
        mc_interval=(args.monte_carlo_interval or None),
        pivot_sampler=pivot, jump_sampler=jump,
        anneal_factor=args.anneal_factor,
        anneal_duration=(args.anneal_duration
                         if args.anneal_duration > 0 else None),
        do_recenter=not args.disable_recentering,
        xy_recenter_only=args.disable_z_recentering, seed=args.seed)
    state = sim.initial_state(pos, n_sys, temps)

    if args.potential_deriv_agreement:
        per_term = system.evaluate(pos[:1], params=p_first)[2]
        for name, v in sorted(per_term.items()):
            print(f"{name}: {float(v[0]): 4.3f}")
        rel = potential_deriv_agreement(system, p_first, pos[0])
        print(f"overall potential relative error:  {rel:.5f}", flush=True)

    rex = None
    replica_interval = 0
    if args.replica_interval > 0:
        swap_sets = parse_swap_sets(args.swap_set, n_sys)
        if not swap_sets:
            sys.exit("replica exchange requested but no swap sets proposed")
        rex = ReplicaExchange(swap_sets, n_sys)
        replica_interval = max(1, int(round(args.replica_interval
                                            / (3 * dt))))

    os.makedirs(args.output_dir, exist_ok=True)
    invocation = " ".join(sys.argv if argv is None
                          else [sys.argv[0]] + list(argv))
    pos_np = pos.cpu().numpy()
    loggers = []
    for i, c in enumerate(args.configs):
        seq = loaded[c][2].get("input", {}).get("sequence")
        loggers.append(H5Logger(output_path(args.output_dir, c, i),
                                invocation=invocation, input_pos=pos_np[i],
                                sequence=seq))

    def on_frame(done, v):
        log_values(loggers, 3 * dt * done, v)
        if args.verbose:
            print(v["console"], flush=True)

    # signal-safe shutdown (reference main.cpp:26-89, 610-674): finish the
    # current chunk, flush every logger, restore handlers, re-raise
    stop_requested = []

    def _request_stop(signum, frame):
        stop_requested.append(signum)
        print(f"\nreceived signal {signum}; finishing current chunk and "
              "flushing logs", flush=True)

    old_handlers = {sig: signal.signal(sig, _request_stop)
                    for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        state, _ = run_ensemble(
            sim, state, params, spec, sim.n_round, rex, replica_interval,
            frame_callback=on_frame, log_level=args.log_level,
            stop=lambda: bool(stop_requested))
    finally:
        for lg in loggers:
            lg.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    if stop_requested:
        # the standard death-by-signal status (main.cpp:73-86)
        print(f"exiting after signal {stop_requested[0]} (all "
              f"{state.round_num}-round frames flushed)", flush=True)
        signal.signal(stop_requested[0], signal.SIG_DFL)
        signal.raise_signal(stop_requested[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
