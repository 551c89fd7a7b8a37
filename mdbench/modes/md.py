"""MD cells: an ensemble of independent replicas of one protein driven by
the program's `Simulation.advance` in chunks of rounds, as a sampling job
runs it: no exchange, no frames, no recentring.

Set-up builds the program's `System` from the configuration's bundle, loads
its kernels' library, makes the momenta from the seed and runs two chunks
from the initial state on a copy (every shape and path the window takes:
with one, the window's second chunk still warms up, some 3 s of it at
4,096 ubiquitin replicas).
The window then advances the initial state chunk by chunk until
`--seconds` have passed, and ends on a device synchronisation.  Before each
chunk it copies the sampled replicas' positions and momenta.

After the window the program is freed and the reference follows the
checked chunks (the first, the last, and those drawn from the seed) from
the program's state at their start, with the same thermostat noise, and
`compare.state_gaps` measures how far the program's end lies from the
reference's.  The reference runs BP to convergence at every evaluation and
never carries the program's solver state, so it checks the program's warm
start as it checks the rest.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from mdbench import compare, harness, inputs
from mdbench.reference import md as ref_md
from mdbench.reference.forcefield import ForceField, load_bundle
from mdbench.trace import Traced


class Run:
    def __init__(self, workload, device, seed):
        self.wl, self.device, self.seed = workload, torch.device(device), seed

    def _program(self):
        from upside_md_torch.md.sim import Simulation
        from upside_md_torch.ops import kernels
        from upside_md_torch.system import System
        wl = self.wl
        system, pos0 = System.from_bundle(harness.bundle_path(wl["config"]),
                                          self.device)
        if self.device.type == "cuda":
            kernels.library()
        sim = Simulation(system, dt=wl["dt"],
                         thermostat_timescale=wl["thermostat_timescale"],
                         thermostat_interval=wl["thermostat_interval"],
                         do_recenter=False, seed=harness.mix_seed(self.seed,
                                                                  "sim"))
        B = wl["replicas"]
        shape = (B,) + tuple(pos0.shape)
        state = sim.initial_state(pos0, B, wl["temperature"])
        state = dataclasses.replace(state, mom=inputs.momenta(
            self.seed, shape, wl["temperature"], self.device))
        return sim, state, inputs.Noise(self.seed, shape, self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self, seconds, trace, t_start):
        from upside_md_torch.ops import bp_pairs
        wl = self.wl
        chunk, B = wl["chunk_rounds"], wl["replicas"]
        sample = inputs.sample(self.seed, B, wl["check_replicas"]).to(
            self.device)
        sim, state0, noise = self._program()
        warm = state0
        for _ in range(2):
            warm = sim.advance(warm, chunk, noise=noise)
        del warm
        self._sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        syncs0 = bp_pairs.HOST_SYNCS["bp_solve_plain"]
        state, starts, traced_chunks, prof = state0, [], [], None
        trace_from = 1
        trace_to = trace_from + wl["trace_chunks"] if trace else -1
        while True:
            k = len(starts)
            if k == trace_from and trace:
                self._sync()
                prof = _profiler()
                prof.start()
            if trace_from <= k < trace_to:
                traced_chunks.append([state.pos.clone()])
            starts.append((state.pos[sample].clone(),
                           state.mom[sample].clone()))
            state = sim.advance(state, chunk, noise=noise)
            if trace_from <= k < trace_to:
                traced_chunks[-1].append(state.pos.clone())
            if k + 1 == trace_to:
                self._sync()
                prof.stop()
            if time.perf_counter() - t0 >= seconds and (
                    not trace or k + 1 >= trace_to):
                break
        self._sync()
        window = time.perf_counter() - t0
        n_chunks = len(starts)
        evals = 3 * chunk * n_chunks
        result = {"metrics": {}, "attempted": B * chunk * n_chunks}
        result["device"] = harness.device_record(self.device)
        ends = {n_chunks - 1: (state.pos[sample].clone(),
                               state.mom[sample].clone())}
        for k in range(n_chunks - 1):
            ends[k] = starts[k + 1]
        counters = {
            "bp_sweeps_per_eval": float(state.bp_sweeps.double().sum())
            / B / max(state.n_evals, 1),
            "bp_host_syncs_per_eval":
                (bp_pairs.HOST_SYNCS["bp_solve_plain"] - syncs0) / evals}
        del state, state0, sim, noise
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        nodes, _ = load_bundle(harness.bundle_path(wl["config"]))
        if trace:
            ff_count = ForceField(nodes, self.device, torch.float64)
            traced = Traced(prof, 3 * chunk * len(traced_chunks), counters,
                            {"ff": ff_count, "replicas": B, "chunks": [
                                (a, b, 3 * chunk) for a, b in traced_chunks]})
            del prof
            harness.read_metrics(wl, traced, result)
            del traced, traced_chunks, ff_count
        else:
            result["metrics"]["steps_per_s"] = {
                "value": evals * B / window, "unit": "steps/s"}
            result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}

        self.window = (nodes, starts, ends, n_chunks)
        readings = self.gaps(lambda k, ff: ends[k])
        print(f"worst gaps: {readings['pos_gap_max']!r} (positions), "
              f"{readings['mom_gap_max']!r} (momenta)", file=sys.stderr)
        result["correct"], result["checks"] = harness.judge(readings,
                                                            wl["limits"])
        # a run whose outputs are wrong counts its checked chunks as failed
        result["failed"] = 0 if result["correct"] else len(
            self.checked_chunks(n_chunks)) * wl["check_replicas"]
        return result

    def checked_chunks(self, n_chunks):
        """The first and last chunk and `check_drawn` more drawn from the
        seed."""
        middle = list(range(1, n_chunks - 1))
        g = torch.Generator()
        g.manual_seed(harness.mix_seed(self.seed, "chunks"))
        drawn = [middle[i] for i in torch.randperm(len(middle), generator=g)[
            :self.wl["check_drawn"]].tolist()]
        return sorted({0, n_chunks - 1, *drawn})

    def follow(self, ff, start, first_round, block=16, state_dtype=None):
        """The reference's state after one chunk from `start`, the sampled
        replicas in blocks."""
        wl = self.wl
        sample = inputs.sample(self.seed, wl["replicas"],
                               wl["check_replicas"]).to(self.device)
        noise = inputs.Noise(self.seed, (wl["replicas"],)
                             + tuple(start[0].shape[1:]), self.device)
        every = max(1, round(wl["thermostat_interval"] / (3 * wl["dt"])))
        out = []
        for i in range(0, len(sample), block):
            rows = sample[i:i + block]
            out.append(ref_md.follow(
                ff, start[0][i:i + block], start[1][i:i + block],
                first_round, wl["chunk_rounds"], wl["dt"], every,
                wl["thermostat_timescale"], wl["temperature"],
                lambda nr: noise(nr)[rows], state_dtype))
        return tuple(torch.cat(part) for part in zip(*out))

    def gaps(self, side, dtype=torch.float64):
        """The readings (`compare.md_readings`) over the checked chunks of
        the last window, with side(k, ff) the compared end of chunk k."""
        nodes, starts, ends, n_chunks = self.window
        ff = ForceField(nodes, self.device, dtype)
        gaps = []
        for k in self.checked_chunks(n_chunks):
            ref = self.follow(ff, starts[k], k * self.wl["chunk_rounds"])
            gaps.append(compare.state_gaps(starts[k], side(k, ff), ref))
            for name, g in gaps[-1].items():
                print(f"chunk {k} {name} by sampled replica: "
                      f"{[round(float(x), 6) for x in g]}", file=sys.stderr)
        return compare.md_readings(gaps, self.wl["gap_caps"])

    def control(self, dtype=torch.bfloat16):
        """The readings of the reference in the program's place with its
        force evaluations computed in `dtype` (the state kept in float32,
        as the program keeps it), over the last window's checked chunks."""
        nodes, starts, _, _ = self.window
        low = ForceField(nodes, self.device, dtype)
        return self.gaps(lambda k, ff: self.follow(
            low, starts[k], k * self.wl["chunk_rounds"],
            state_dtype=torch.float32))


def _profiler():
    # device activity and the CUDA runtime's calls alone: recording every
    # host operator as well slows the host's enqueue, and so the window
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])
