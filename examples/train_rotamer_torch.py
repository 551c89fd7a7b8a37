#!/usr/bin/env python
"""End-to-end rotamer-table training demo (energy-gap objective), on the
port (counterpart of examples/train_rotamer.py).

The reference trains its sidechain interaction tables by maximizing the
probability of native rotamer states: the loss is the free-energy cost of
pinning every side chain to its native state, E_fixed - F_free, with the
table gradient flowing through the belief-propagation envelope
(py/rotamer_parameter_estimation.py:213-263).

This demo runs that loop on Trp-cage (full force field, a `.up` built by
`bench_systems.full_builder` into a temporary directory):

  1. equilibrate briefly and take a conformation batch,
  2. define "native" states as the table's own argmax marginals,
  3. degrade the table in the constrained packing space (training.py
     QuadsplinePacking: every iterate is a physically valid table),
  4. train the degraded table with the energy-gap loss (`fit_packed`),
  5. report rotamer-state and chi1-bin accuracy before and after.

    python examples/train_rotamer_torch.py [--device cuda|cpu]
        [--frames 6] [--steps 120]

With the reference's libraries (`UPSIDE_PARAM_DIR`) this is the JAX demo.
Without them it runs on the committed synthetic libraries with smooth
Rama maps: the loss falls, but the synthetic tables carry no native
structure, so the accuracy recovery the JAX demo's test asserts (and
skips without the libraries) is not shown here.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from upside_md_torch import bench_systems as bs  # noqa: E402
from upside_md_torch.config.reader import load_up  # noqa: E402
from upside_md_torch.md.sim import Simulation  # noqa: E402
from upside_md_torch.system import System  # noqa: E402
from upside_md_torch.training import (energy_gap_loss,  # noqa: E402
                                      fit_packed, rotamer_node_marginals,
                                      rotamer_packings,
                                      rotamer_state_restricted_system)


def build_config(path):
    """Write the demo's Trp-cage `.up` (build_full_system's build with
    `example_rama_maps`) at `path`; returns path."""
    b = bs.full_builder(bs.TRP_CAGE,
                        rama_maps=bs.example_rama_maps(len(bs.TRP_CAGE)))
    return b.write(path)


def load_config(path, device="cuda", dtype=torch.float32):
    """(system, initial positions (n_atom, 3), aux) of a `.up`."""
    records, pos, aux = load_up(path)
    system, pos = System.from_records(records, pos, device, dtype)
    return system, pos, aux


def conformation_batch(system, pos, n_frames, seed):
    """n_frames configurations (n_frames, n_atom, 3), 10 MD rounds apart,
    from a short run at temperature 0.8."""
    sim = Simulation(system, dt=0.009, thermostat_interval=0.135,
                     do_recenter=False, seed=seed)
    state = sim.initial_state(pos, 1, 0.8)
    frames = []
    for _ in range(n_frames):
        state = sim.advance(state, 10)
        frames.append(state.pos[0])
    return torch.stack(frames)


def degrade(params, seed, scale=0.4):
    """The parameters with the rotamer table moved by a seeded normal of
    `scale` in its packing space (valid by construction)."""
    pk = rotamer_packings(params)["rotamer"]
    table = params["rotamer"]["interaction_param"]
    theta = pk.pack(table)
    theta_bad = theta + scale * np.random.default_rng(seed).normal(
        size=theta.shape)
    bad = {k: dict(v) for k, v in params.items()}
    bad["rotamer"]["interaction_param"] = pk.unpack(torch.as_tensor(
        theta_bad, dtype=table.dtype, device=table.device))
    return bad


def train(system, pos_batch, params, target_states, n_steps,
          learning_rate=0.02):
    """`fit_packed` of the rotamer table under the energy-gap loss of
    pinning the side chains to `target_states`, meaned over the batch.
    Returns (fitted params, loss history)."""
    fixed = rotamer_state_restricted_system(system, target_states)
    loss = energy_gap_loss(fixed, system, pos_batch)
    return fit_packed(system, lambda p: loss(p, {}), params, ["rotamer"],
                      n_steps=n_steps, learning_rate=learning_rate)


def state_accuracy(system, pos_batch, params, target_states):
    """The share of multi-rotamer residues whose argmax marginal is the
    target state, over the batch."""
    nb = rotamer_node_marginals(system, pos_batch, params).cpu().numpy()
    multi = np.asarray(system.by_name["rotamer"].consts["n_rot_per_res"]) \
        > 1
    hits = nb.argmax(-1)[:, multi] == np.asarray(target_states)[multi]
    return float(hits.mean()) if multi.any() else 0.0


def chi1_bin_accuracy(seq3, states_pred, states_true, library):
    """Map library states to chi1 bins (120-degree wells) and compare."""
    from upside_md_torch.chi1 import Chi1Predict
    cp = Chi1Predict.from_library(library)
    rt = np.asarray([cp.restype_dict[a] for a in seq3])
    b_pred = cp.state_to_bin[rt, states_pred]
    b_true = cp.state_to_bin[rt, states_true]
    keep = (b_true >= 0) & (b_pred >= 0)
    return float((b_pred[keep] == b_true[keep]).mean())


def main(n_frames=6, n_train_steps=120, seed=3, device="cuda", config=None):
    """The five steps; `config` a `.up` to train on instead of the demo's.
    Returns (loss history, accuracy before, accuracy after)."""
    with tempfile.TemporaryDirectory() as tmp:
        system, pos, aux = load_config(
            config or build_config(os.path.join(tmp, "trp_cage.up")),
            device)
    params = system.params

    # 1. conformation batch from a short equilibration
    pos_batch = conformation_batch(system, pos, n_frames, seed)

    # 2. "native" states: the table's own argmax marginals on the first
    #    frame (stands in for crystallographic chi1 assignments)
    target_states = rotamer_node_marginals(
        system, pos_batch[0], params).argmax(-1).cpu().numpy()

    # 3. degrade the table in packing space (valid by construction)
    params_bad = degrade(params, seed)
    acc0 = state_accuracy(system, pos_batch, params_bad, target_states)

    # 4. energy-gap training of the degraded table
    fitted, history = train(system, pos_batch, params_bad, target_states,
                            n_train_steps)
    acc1 = state_accuracy(system, pos_batch, fitted, target_states)

    # 5. the accuracies
    print(f"energy-gap loss: {history[0]:.3f} -> {history[-1]:.3f}")
    print(f"rotamer-state accuracy (multi-rotamer residues): "
          f"{acc0:.3f} -> {acc1:.3f}")
    seq = aux.get("input", {}).get("sequence")
    seq3 = None if seq is None else [s.decode() for s in seq]
    n_res_bp = len(target_states)
    if seq3 is not None and len(seq3) == n_res_bp:
        library = bs.SIDECHAIN if bs.have_reference_params() \
            else bs.SIDECHAIN_SYNTH
        nb_bad, nb_fit = (rotamer_node_marginals(
            system, pos_batch[0], p).argmax(-1).cpu().numpy()
            for p in (params_bad, fitted))
        c0 = chi1_bin_accuracy(seq3, nb_bad, target_states, library)
        c1 = chi1_bin_accuracy(seq3, nb_fit, target_states, library)
        print(f"chi1-bin accuracy: {c0:.3f} -> {c1:.3f}")
    return history, acc0, acc1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu: every kernel's "
                         "plain version)")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--steps", type=int, default=120)
    a = ap.parse_args()
    main(a.frames, a.steps, device=a.device)
