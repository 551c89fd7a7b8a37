#!/usr/bin/env python
"""Example: constant-temperature MD of Trp-cage with the full force field,
on the port (counterpart of examples/fold_trp_cage.py).

Builds a `.up` configuration from the sequence and parameter libraries
with the port's `ConfigBuilder`, runs MD through the port's command line
in process (`run.run_upside`), and exports the trajectory to PDB and VTF.

    python examples/fold_trp_cage_torch.py /tmp/trpcage --duration 270
        [--device cuda|cpu]

The libraries are the reference's when `UPSIDE_PARAM_DIR` holds them;
otherwise the committed synthetic libraries (`upside_md_torch/data/libs`)
with smooth synthetic Rama maps (`bench_systems.example_rama_maps`), still
the full force field (the JAX example falls back to the backbone only,
and reads the reference's Rama library whatever it has).  The frames go
to `<workdir>/trpcage_0.h5` (the port's command line writes one file a
replica slot and never into the configuration).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from upside_md_torch import bench_systems as bs  # noqa: E402
from upside_md_torch.cli import output_path  # noqa: E402
from upside_md_torch.config.builder import ConfigBuilder  # noqa: E402
from upside_md_torch.io.trajectory import (load_upside_traj,  # noqa: E402
                                           write_pdb, write_vtf)
from upside_md_torch.run import run_upside  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('workdir')
    p.add_argument('--duration', type=float, default=27.0)
    p.add_argument('--temperature', default='0.85')
    p.add_argument('--backbone-only', action='store_true')
    p.add_argument('--device', default='cuda',
                   help='torch device to run on (cpu: every kernel\'s '
                        'plain version)')
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    config = os.path.join(args.workdir, 'trpcage.up')
    ref = bs.have_reference_params()
    sidechain = bs.SIDECHAIN if ref else bs.SIDECHAIN_SYNTH
    environment = bs.ENVIRONMENT if ref else bs.ENVIRONMENT_SYNTH

    b = ConfigBuilder(f'>trp-cage\n{bs.TRP_CAGE}\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(bs.example_rama_maps(b.n_res))
    b.add_backbone_pairs()
    if args.backbone_only:
        b.add_hbond(hbond_energy=-2.1119)
    else:
        b.add_rotamer_sidechains(sidechain, sidechain, damping=0.4,
                                 dynamic_1body=True)
        b.add_hbond(hbond_energy=-2.1119, coverage_library=sidechain)
        b.add_environment(environment)
        b.add_rotamer_node()
    b.write(config)

    run_upside([config], duration=args.duration,
               frame_interval=max(args.duration / 100, 0.027),
               temperature=args.temperature,
               extra_args=['--monte-carlo-interval=0.27'],
               device=args.device, output_dir=args.workdir)

    seq, time_, pos = load_upside_traj(output_path(args.workdir, config, 0))
    write_pdb(os.path.join(args.workdir, 'traj.pdb'), seq, pos)
    write_vtf(os.path.join(args.workdir, 'traj.vtf'), seq, pos)
    print(f'wrote {len(pos)} frames to {args.workdir}/traj.pdb and .vtf')
    return pos


if __name__ == '__main__':
    main()
