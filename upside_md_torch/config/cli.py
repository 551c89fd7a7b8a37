"""`upside_config`-compatible command line without h5py (port of
upside_md_tpu/config/cli.py; reference py/upside_config.py:1199-1671).

A thin argparse front end over the port's ConfigBuilder with the JAX
package's flag names, errors and builder call order, so a pipeline that
builds a `.up` with either package can switch to the other.  All flag
values are archived as attributes of /input/args like the reference
(upside_config.py:1464-1467), written with the configuration in one
`io/h5.Writer` session (the JAX package reopens the file with h5py).

Run as `python -m upside_md_torch.config.cli --fasta seq.fa --output
sys.up ...` or through upside_md_torch.run.upside_config.
"""

from __future__ import annotations

import argparse
import pickle
import sys

import numpy as np

from ..io import h5


def parse_segments(s):
    """'10-13,17,19-21' -> array of residue indices
    (upside_config.py parse_segments)."""
    out = []
    for part in s.split(','):
        if '-' in part:
            lo, hi = part.split('-')
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return np.array(sorted(set(out)), np.int32)


def _read_table(path, header_fields, parser=None):
    """Whitespace table with a mandatory header whose first columns must
    match header_fields (reference table-file conventions)."""
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    header = lines[0]
    if [h.lower() for h in header[:len(header_fields)]] != \
            [h.lower() for h in header_fields]:
        raise SystemExit(
            f"{path}: header must start with {' '.join(header_fields)}")
    rows = lines[1:]
    if parser is not None:
        return [parser(r) for r in rows]
    return [[float(x) for x in r[:len(header_fields)]] for r in rows]


def _read_fix_rotamer(path, fasta):
    """'residue restype rotamer' table -> {residue: rotamer}, checking the
    restype against the FASTA (upside_config.py --fix-rotamer)."""
    fix = {}
    for row in _read_table(path, ["residue", "restype", "rotamer"],
                           parser=lambda r: r):
        residue, restype, rotamer = int(row[0]), row[1], int(row[2])
        if fasta[residue] != restype:
            raise SystemExit(
                f"fix-rotamer: residue {residue} is {fasta[residue]} in the "
                f"FASTA but {restype} in the table")
        fix[residue] = rotamer
    return fix


def _read_fasta_file(path):
    with open(path) as f:
        return f.read()


def _load_pickle_pos(path, n_atom):
    pos = pickle.load(open(path, 'rb'), encoding='latin1')
    pos = np.asarray(pos)
    if pos.ndim == 3:
        pos = pos[..., 0]
    assert pos.shape == (n_atom, 3), (
        f"{path}: expected ({n_atom}, 3) positions, got {pos.shape}")
    return pos


def build_parser():
    p = argparse.ArgumentParser(
        description='Prepare Upside-TPU input file (.up)',
        usage='use "%(prog)s --help" for more information')
    add = p.add_argument
    add('--fasta', required=True, help='[required] FASTA sequence file')
    add('--output', default='system.h5', required=True,
        help='path of the output system file')
    add('--target-structure', default='',
        help='target .initial.pkl structure recorded under /target')
    add('--no-backbone', dest='backbone', default=True,
        action='store_false', help='disable rigid backbone sterics')
    add('--rotamer-placement', default=None,
        help='rotameric sidechain library')
    add('--dynamic-rotamer-placement', default=False, action='store_true')
    add('--dynamic-rotamer-1body', default=False, action='store_true')
    add('--fix-rotamer', default='',
        help='table "residue restype rotamer" of fixed rotamers')
    add('--rotamer-interaction', default=None,
        help='rotamer sidechain pair interaction parameters')
    add('--rotamer-solve-damping', default=0.4, type=float)
    add('--sidechain-radial', default=None,
        help='sidechain radial potential library')
    add('--sidechain-radial-exclude-residues', default=[],
        type=parse_segments)
    add('--bond-stiffness', default=48., type=float)
    add('--angle-stiffness', default=175., type=float)
    add('--rama-library', default='', help='smooth Rama probability library')
    add('--rama-library-combining-rule', default='mixture',
        choices=['mixture', 'product'])
    add('--rama-sheet-mixing-energy', default=None, type=float)
    # accepted for command-line compatibility: the reference parses this
    # flag but never reads it (upside_config.py:1246 — the sheet maps come
    # from the 'sheet' group of --rama-library instead)
    add('--rama-sheet-library', default=None,
        help='accepted for compatibility; sheet maps are read from the '
             '"sheet" group of --rama-library (as the reference does)')
    # the reference comments this flag out (upside_config.py:1244); here
    # it is wired to the working TorusDBN/fixed-HMM rama prior
    add('--torus-dbn-library', default='',
        help='TorusDBN Rama probability function (HMM prior)')
    add('--secstr-bias', default='',
        help='table "residue secstr energy" (secstr: helix|sheet)')
    add('--hbond-energy', default=0., type=float)
    add('--hbond-exclude-residues', default=[], type=parse_segments)
    add('--chain-break-from-file', default='',
        help='file of chain-first-residue indices (+ optional rl_chains '
             'line) from PDB_to_initial_structure')
    add('--loose-hbond-criteria', default=False, action='store_true')
    add('--z-flat-bottom', default='',
        help='table "residue z0 radius spring_constant"')
    add('--tension', default='',
        help='table "residue tension_x tension_y tension_z"')
    add('--ask-before-using-AFM', default='',
        help='table "residue spring_const tip_pos_x tip_pos_y tip_pos_z '
             'pulling_vel_x pulling_vel_y pulling_vel_z"')
    add('--AFM-time-initial', default=0., type=float)
    add('--AFM-time-step', default=0.009, type=float)
    add('--initial-structure', default='',
        help='pickle of (n_atom, 3, 1) initial positions')
    add('--restraint-group', default=[], action='append',
        type=parse_segments)
    add('--apply-restraint-group-to-each-chain', action='store_true')
    add('--restraint-spring-constant', default=4., type=float)
    add('--contact-energies', default='',
        help='table "residue1 residue2 energy distance transition_width"')
    add('--environment-potential', default='')
    add('--reference-state-rama', default='',
        help='do not use this unless you know what you are doing')
    add('--membrane-thickness', default=None, type=float)
    add('--membrane-potential', default='')
    add('--membrane-exclude-residues', default=[], type=parse_segments)
    grp = p.add_mutually_exclusive_group()
    grp.add_argument('--cavity-radius', default=0., type=float)
    grp.add_argument('--debugging-only-heuristic-cavity-radius',
                     default=0., type=float)
    grp.add_argument('--cavity-radius-from-config', default='')
    add('--make-unbound', action='store_true')
    add('--debugging-only-disable-basic-springs', default=False,
        action='store_true')
    add('--seed', default=0, type=int,
        help='seed for the random initial chain (TPU-port extension)')
    return p


def main(argv=None):
    from .builder import (ConfigBuilder, apply_secstr_bias,
                          read_weighted_maps)

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.restraint_group and not args.initial_structure:
        parser.error('must specify --initial-structure to use '
                     '--restraint-group')
    if args.apply_restraint_group_to_each_chain and \
            not args.chain_break_from_file:
        parser.error('--apply-restraint-group-to-each-chain requires '
                     '--chain-break-from-file')
    if args.make_unbound and not args.chain_break_from_file:
        parser.error('--make-unbound requires --chain-break-from-file')
    if args.dynamic_rotamer_placement:
        parser.error('--dynamic-rotamer-placement is not supported by the '
                     'TPU port (the reference marks it not recommended); '
                     'use fixed placement')
    if args.environment_potential and args.rotamer_placement is None:
        parser.error('--rotamer-placement is required, based on other '
                     'options.')
    if args.membrane_potential and args.membrane_thickness is None:
        parser.error('--membrane-potential requires --membrane-thickness')

    fasta_text = _read_fasta_file(args.fasta)
    init_pos = None
    b_probe = ConfigBuilder(fasta_text, seed=args.seed)  # for n_atom only
    n_res, n_atom = b_probe.n_res, b_probe.n_atom
    if args.initial_structure:
        init_pos = _load_pickle_pos(args.initial_structure, n_atom)

    # chain breaks (reference reads them before hbond so break-adjacent
    # residues get hbond-excluded, upside_config.py:1419-1459)
    chain_first_residue = np.array([], np.int32)
    rl_chains = None
    n_chains = 1
    if args.chain_break_from_file:
        try:
            with open(args.chain_break_from_file) as infile:
                chain_dat = [ln.split() for ln in infile if ln.strip()]
        except IOError:
            chain_dat = []
        if chain_dat:
            chain_first_residue = np.array(chain_dat[0], np.int32)
            n_chains = chain_first_residue.size + 1
            if len(chain_dat) > 1:
                rl_chains = np.array(chain_dat[-1], np.int32)
        if chain_first_residue.size:
            required = np.array([i + j for i in chain_first_residue
                                 for j in (-1, 0)], np.int32)
            args.hbond_exclude_residues = np.unique(np.concatenate(
                [np.asarray(args.hbond_exclude_residues, np.int32),
                 required]))

    def chain_endpts(i):
        starts = np.concatenate([[0], chain_first_residue, [n_res]])
        return int(starts[i]), int(starts[i + 1])

    # cavity radius resolution (mutually exclusive group semantics)
    cavity_radius = args.cavity_radius
    if args.debugging_only_heuristic_cavity_radius:
        if n_chains < 2:
            print('WARNING: heuristic cavity radius requires >= 2 chains; '
                  'skipping', file=sys.stderr)
        else:
            pos0 = init_pos if init_pos is not None else b_probe.pos
            dists = []
            for i in range(n_chains):
                fr, nf = chain_endpts(i)
                com = pos0[fr * 3:nf * 3].mean(0)
                dists.extend(np.linalg.norm(pos0 - com, axis=-1))
            cavity_radius = (args.debugging_only_heuristic_cavity_radius *
                             max(dists))
    if args.cavity_radius_from_config:
        with h5.File(args.cavity_radius_from_config) as t:
            cavity_radius = float(
                t['input/potential/cavity_radial/radius'][0])

    # unbound displacement happens before restraint groups capture their
    # equilibrium distances (upside_config.py:1549-1581)
    if args.make_unbound and n_chains >= 2 and cavity_radius:
        if init_pos is None:
            init_pos = b_probe.pos.copy()
        displacement = np.array([[-1., 0., 0.], [1., 0., 0.],
                                 [0., -1., 0.], [0., 1., 0.],
                                 [0., 0., -1.], [0., 0., 1.]])
        if rl_chains is None:
            for j in range(n_chains):
                fr, nf = chain_endpts(j)
                init_pos[fr * 3:nf * 3] += \
                    displacement[j] * 0.5 * cavity_radius
        else:
            fr = chain_endpts(0)[0]
            nf = chain_endpts(int(rl_chains[0]) - 1)[1]
            init_pos[fr * 3:nf * 3] += displacement[0] * 0.5 * cavity_radius
            fr = chain_endpts(int(rl_chains[0]))[0]
            nf = chain_endpts(n_chains - 1)[1]
            init_pos[fr * 3:nf * 3] += displacement[1] * 0.5 * cavity_radius

    b = ConfigBuilder(fasta_text, initial_pos=init_pos, seed=args.seed)

    if args.target_structure:
        b.add_target_structure(_load_pickle_pos(args.target_structure,
                                                n_atom))

    if not args.debugging_only_disable_basic_springs:
        b.add_backbone_springs(bond_stiffness=args.bond_stiffness,
                               angle_stiffness=args.angle_stiffness)

    if chain_first_residue.size:
        b.add_chain_breaks(chain_first_residue, rl_chains=rl_chains)

    fix = (_read_fix_rotamer(args.fix_rotamer, b.fasta)
           if args.fix_rotamer else None)
    if args.rotamer_placement:
        b.add_rotamer_sidechains(args.rotamer_placement,
                                 args.rotamer_interaction,
                                 damping=args.rotamer_solve_damping,
                                 dynamic_1body=args.dynamic_rotamer_1body,
                                 fix_rotamer=fix)

    if args.hbond_energy:
        b.add_hbond(hbond_energy=args.hbond_energy,
                    exclude_residues=args.hbond_exclude_residues,
                    loose=args.loose_hbond_criteria,
                    coverage_library=args.rotamer_interaction)

    if args.environment_potential:
        b.add_environment(args.environment_potential)

    if args.rotamer_placement and args.rotamer_interaction:
        b.add_rotamer_node()

    if args.torus_dbn_library:
        b.add_torus_dbn(args.torus_dbn_library)

    if args.rama_library:
        pots = read_weighted_maps(list(b.seq_with_cpr), args.rama_library,
                                  args.rama_sheet_mixing_energy,
                                  args.rama_library_combining_rule)
        if args.secstr_bias:
            entries = _read_table(args.secstr_bias,
                                  ["residue", "secstr", "energy"],
                                  parser=lambda r: (int(r[0]), r[1],
                                                    float(r[2])))
            pots = apply_secstr_bias(pots, entries)
        b.add_rama_map_pot(pots)
    else:
        print('WARNING: running without any Rama potential !!!',
              file=sys.stderr)

    if args.reference_state_rama:
        ref_cor = np.log(np.asarray(pickle.load(
            open(args.reference_state_rama, 'rb'), encoding='latin1')))
        ref_cor = ref_cor - ref_cor.mean()
        b.require_rama = True
        g = b._group('rama_map_pot_ref', ['rama_coord'],
                     residue_id=np.arange(n_res),
                     rama_map_id=np.zeros(n_res, np.int32),
                     rama_pot=ref_cor[None])
        g['attrs']['log_pot'] = 0

    if cavity_radius:
        b.add_cavity_radial(cavity_radius)

    if args.backbone:
        b.add_backbone_pairs()

    if args.z_flat_bottom:
        b.add_z_flat_bottom(_read_table(
            args.z_flat_bottom, ["residue", "z0", "radius",
                                 "spring_constant"]))

    if args.tension and args.ask_before_using_AFM:
        raise SystemExit('you cannot pull the protein using two modes; '
                         'choose one')
    if args.tension:
        b.add_tension(_read_table(args.tension,
                                  ["residue", "tension_x", "tension_y",
                                   "tension_z"]))
    elif args.ask_before_using_AFM:
        b.add_afm(_read_table(args.ask_before_using_AFM,
                              ["residue", "spring_const", "tip_pos_x",
                               "tip_pos_y", "tip_pos_z", "pulling_vel_x",
                               "pulling_vel_y", "pulling_vel_z"]),
                  time_initial=args.AFM_time_initial,
                  time_step=args.AFM_time_step)

    if args.sidechain_radial:
        b.add_sidechain_radial(args.sidechain_radial,
                               args.sidechain_radial_exclude_residues)

    if args.membrane_potential:
        b.add_membrane_potential(args.membrane_potential,
                                 args.membrane_thickness,
                                 args.membrane_exclude_residues,
                                 args.hbond_exclude_residues)

    if args.contact_energies:
        rows = np.asarray(_read_table(
            args.contact_energies,
            ["residue1", "residue2", "energy", "distance",
             "transition_width"]))
        b.add_contacts(rows[:, 0:2].astype(np.int32), rows[:, 2],
                       rows[:, 3], rows[:, 4])

    restraint_groups = [np.asarray(g) for g in args.restraint_group]
    if args.apply_restraint_group_to_each_chain and n_chains > 1:
        if rl_chains is not None:
            fr = chain_endpts(0)[0]
            nf = chain_endpts(int(rl_chains[0]) - 1)[1]
            restraint_groups.append(np.arange(fr, nf))
            fr = chain_endpts(int(rl_chains[0]))[0]
            nf = chain_endpts(n_chains - 1)[1]
            restraint_groups.append(np.arange(fr, nf))
        else:
            for i in range(n_chains):
                fr, nf = chain_endpts(i)
                restraint_groups.append(np.arange(fr, nf))
    for i, group in enumerate(restraint_groups):
        assert int(np.max(group)) < n_res
        b.add_restraint_group(set(int(x) for x in group),
                              strength=args.restraint_spring_constant,
                              group_num=i)

    # archive every flag value + the invocation as /input/args attrs
    # (upside_config.py:1464-1467)
    archive = {}
    for k, v in sorted(vars(args).items()):
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            v = np.asarray(v) if len(v) and not isinstance(
                v[0], np.ndarray) else str(v)
        if isinstance(v, np.ndarray) and v.size == 0:
            v = ''
        archive[k] = v
    archive['invocation'] = ' '.join(sys.argv)
    b.write(args.output, args=archive)
    return args.output


if __name__ == '__main__':
    main()
