"""Makes a pool of MD frames of one configuration, from which a training
cell draws its contrastive-divergence ensemble (`inputs.ensemble`).

    python3 mdbench/make_frames.py --config CONFIG --name NAME

256 independent trajectories start from the bundle's structure with
momenta from seed 1, run 100 rounds and then keep a frame every 20 rounds,
8 of them (`POOL`), at the MD cells' settings (T 0.85, dt 0.009, a
thermostat round every 0.135 time units, timescale 5).  The
dynamics are the plain reference's (`reference/md.py`), in float32 with BP
to the bundle's own tolerance, so the pool owes nothing to the program.
Writes `frames/NAME.npy` (frames x atoms x 3, float32) and `frames/NAME.json`
(how it was made).  The benchmark's runs only read the pool.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

POOL = {"trajectories": 256, "frames": 8, "equilibrate": 100, "every": 20,
        "seed": 1}
SETTINGS = {"temperature": 0.85, "dt": 0.009, "thermostat_interval": 0.135,
            "thermostat_timescale": 5.0}


def make(config, trajectories, frames, equilibrate, every, seed, device):
    """(frames * trajectories, n_atom, 3) float32 on the CPU, frame-major."""
    import torch
    from mdbench import harness, inputs
    from mdbench.reference import md as ref_md
    from mdbench.reference.forcefield import ForceField, load_bundle
    nodes, pos0 = load_bundle(harness.bundle_path(config))
    tol = next(n["consts"]["tol"] for n in nodes if n["type"] == "rotamer")
    ff = ForceField(nodes, device, torch.float32, tol=float(tol))
    s = SETTINGS
    shape = (trajectories,) + tuple(pos0.shape)
    noise = inputs.Noise(seed, shape, device)
    thermostat = max(1, round(s["thermostat_interval"] / (3 * s["dt"])))
    pos = torch.as_tensor(pos0, dtype=torch.float32, device=device
                          ).expand(shape).clone()
    mom = inputs.momenta(seed, shape, s["temperature"], device)
    kept, nr = [], 0
    for n in [equilibrate] + [every] * (frames - 1):
        pos, mom = ref_md.follow(ff, pos, mom, nr, n, s["dt"], thermostat,
                                 s["thermostat_timescale"], s["temperature"],
                                 noise)
        nr += n
        if not (torch.isfinite(pos).all() and torch.isfinite(mom).all()):
            raise RuntimeError(f"the trajectories left the finite numbers "
                               f"by round {nr}")
        kept.append(pos.cpu())
    return torch.cat(kept)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--name", required=True)
    args = ap.parse_args()
    import numpy as np
    import torch
    from mdbench import harness
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    t = time.perf_counter()
    pool = make(harness.load_json("configs", args.config), device=device,
                **POOL)
    seconds = time.perf_counter() - t
    base = os.path.join(harness.BENCH, "frames", args.name)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    np.save(base + ".npy", pool.numpy().astype(np.float32))
    moved = (pool - pool.mean(0)).norm(dim=-1).mean().item()
    info = dict(vars(args), **POOL, **SETTINGS, shape=list(pool.shape),
                device=str(device), seconds=seconds,
                mean_atom_distance_from_pool_mean=moved,
                card=harness.power_limit() if device.type == "cuda" else None)
    with open(base + ".json", "w") as f:
        json.dump(info, f, indent=1)
    print(json.dumps(info))
    return 0 if math.isfinite(moved) else 1


if __name__ == "__main__":
    sys.exit(main())
