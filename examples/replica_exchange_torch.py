#!/usr/bin/env python
"""Example: temperature replica exchange across a ladder of replicas, on
the port (counterpart of examples/replica_exchange.py).

    python examples/replica_exchange_torch.py /tmp/rex --n-replica 8
        [--hamiltonian] [--device cuda|cpu]

One backbone-only Trp-cage configuration a replica slot, temperatures
0.80 1.06^i, even/odd neighbour swap sets every 0.27 time units, through
the port's command line in process (`run.run_upside`).  The Rama maps
are the reference's when `UPSIDE_PARAM_DIR` holds its libraries,
otherwise smooth synthetic ones (`bench_systems.example_rama_maps`; the
JAX example reads the reference's whatever it has).  Each slot's frames
go to `<workdir>/rep<i>_<i>.h5`.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from upside_md_torch.bench_systems import (TRP_CAGE,  # noqa: E402
                                           example_rama_maps)
from upside_md_torch.config.builder import ConfigBuilder  # noqa: E402
from upside_md_torch.md.replica import even_odd_swap_sets  # noqa: E402
from upside_md_torch.run import run_upside  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('workdir')
    p.add_argument('--n-replica', type=int, default=8)
    p.add_argument('--duration', type=float, default=27.0)
    p.add_argument('--hamiltonian', action='store_true',
                   help='per-slot Hamiltonian ladder (hbond-energy scale) '
                        'instead of identical configs; the command line '
                        'detects the differing parameters and evaluates '
                        'each slot under its own Hamiltonian')
    p.add_argument('--device', default='cuda',
                   help='torch device to run on (cpu: every kernel\'s '
                        'plain version)')
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)

    configs = []
    for i in range(args.n_replica):
        b = ConfigBuilder(f'>x\n{TRP_CAGE}\n', seed=1)
        scale = 1.0 + (0.04 * i if args.hamiltonian else 0.0)
        b.add_backbone_springs()
        b.add_rama_map_pot(example_rama_maps(b.n_res))
        b.add_backbone_pairs()
        b.add_hbond(hbond_energy=-2.1119 * scale)
        configs.append(b.write(os.path.join(args.workdir, f'rep{i}.up')))

    temps = 0.80 * (1.06 ** np.arange(args.n_replica))
    swap_sets = [','.join(f'{a}-{b}' for a, b in s)
                 for s in even_odd_swap_sets(args.n_replica)]
    run_upside(configs, duration=args.duration,
               frame_interval=max(args.duration / 50, 0.027),
               temperature=','.join(f'{t:.4f}' for t in temps),
               extra_args=[f'--swap-set={s}' for s in swap_sets] +
                          ['--replica-interval=0.27'],
               device=args.device, output_dir=args.workdir)
    print('replica exchange finished; per-slot trajectories in',
          args.workdir)
    return configs


if __name__ == '__main__':
    main()
