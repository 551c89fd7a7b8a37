"""Build `.up` system files without h5py (port of
upside_md_tpu/config/builder.py; reference py/upside_config.py).

The same HDF5 group/dataset spec as the reference's config compiler, wired
by `arguments` attributes, written through the port's numpy-only
`io/h5.py`: every library is read with `h5.File` and the file is written
with `h5.Writer`.  The numpy operations are the JAX package's, in its
order, so the same inputs give a file whose every dataset and attribute
equals that package's as read back (the file bytes differ).

Geometry constants (backbone bond lengths/angles, reference N/CA/C/CB
geometry, hbond virtual-site lengths) follow the reference values
(upside_config.py:149-212, 480-526, 795-812).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from ..io import h5

deg = np.pi / 180.0

THREE_LETTER_AA = {
    'A': 'ALA', 'C': 'CYS', 'D': 'ASP', 'E': 'GLU', 'F': 'PHE',
    'G': 'GLY', 'H': 'HIS', 'I': 'ILE', 'K': 'LYS', 'L': 'LEU',
    'M': 'MET', 'N': 'ASN', 'P': 'PRO', 'Q': 'GLN', 'R': 'ARG',
    'S': 'SER', 'T': 'THR', 'V': 'VAL', 'W': 'TRP', 'Y': 'TYR'}
ONE_LETTER_AA = {v: k for k, v in THREE_LETTER_AA.items()}

# reference residue frame geometry (upside_config.py:154-158)
REF_N = (-1.19280531, -0.83127186, 0.0)
REF_CA = (0.0, 0.0, 0.0)
REF_C = (1.25222632, -0.87268266, 0.0)
REF_CB = (0.0, 0.94375626, 1.2068012)

N_BIT_ROTAMER = 4


def parse_fasta(text: str):
    """FASTA (one-letter, '*P' marks cis-proline) -> three-letter list."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if lines and lines[0].startswith('>'):
        lines = lines[1:]
    seq = []
    cis = False
    for a in ''.join(lines):
        if cis:
            assert a == 'P', 'cis marker must precede proline'
            seq.append('CPR')
            cis = False
        elif a == '*':
            cis = True
        else:
            seq.append(THREE_LETTER_AA[a])
    return np.array(seq)


# -- initial structure generation (upside_config.py:414-476) ----------------

def make_tab_matrices(phi, theta, bond_length):
    phi, theta, length = map(np.asarray, (phi, theta, bond_length))
    r = np.zeros(phi.shape + (4, 4))
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    r[..., 0, 0] = -ct; r[..., 0, 1] = -st; r[..., 0, 3] = -length * ct
    r[..., 1, 0] = cp * st; r[..., 1, 1] = -cp * ct; r[..., 1, 2] = -sp
    r[..., 1, 3] = length * cp * st
    r[..., 2, 0] = sp * st; r[..., 2, 1] = -sp * ct; r[..., 2, 2] = cp
    r[..., 2, 3] = length * sp * st
    r[..., 3, 3] = 1.0
    return r


def construct_equilibrium_structure(rama, angles, bond_lengths):
    n_res = rama.shape[0]
    t = np.zeros(3 * n_res)
    t[3::3] = rama[:-1, 1]
    t[4::3] = rama[:-1, 2]
    t[5::3] = rama[1:, 0]
    transforms = make_tab_matrices(t, angles.ravel(), bond_lengths.ravel())
    curr = np.eye(4)
    pos = np.zeros((3 * n_res, 3))
    for i, mat in enumerate(transforms):
        curr = curr @ mat
        pos[i] = curr[:3, 3]
    return pos


def random_initial_config(n_res, seed=0):
    rng = np.random.default_rng(seed)
    rama = rng.uniform(-np.pi, np.pi, size=(n_res, 3))
    rama[:, 2] = np.pi  # trans omegas
    angles = np.empty_like(rama)
    angles[:, 0] = 120.0 * deg
    angles[:, 1] = 120.0 * deg
    angles[:, 2] = 109.5 * deg
    lengths = np.empty_like(rama)
    lengths[:, 0] = 1.453
    lengths[:, 1] = 1.526
    lengths[:, 2] = 1.300
    return construct_equilibrium_structure(rama, angles, lengths)


# -- the builder -------------------------------------------------------------

class ConfigBuilder:
    """Assemble a `.up` system file for a protein sequence."""

    def __init__(self, fasta, initial_pos=None, seed=0):
        self.seq_with_cpr = (parse_fasta(fasta) if isinstance(fasta, str)
                             else np.asarray(fasta))
        self.fasta = np.array([('PRO' if x == 'CPR' else x)
                               for x in self.seq_with_cpr])
        self.n_res = len(self.fasta)
        self.n_atom = 3 * self.n_res
        if initial_pos is None:
            initial_pos = random_initial_config(self.n_res, seed)
        self.pos = np.asarray(initial_pos, np.float32)
        assert self.pos.shape == (self.n_atom, 3)
        self.groups: Dict[str, Dict] = {}       # name -> {datasets, attrs, subgroups}
        self.extra_input: Dict[str, Dict] = {}  # e.g. pivot_moves
        self.require_rama = False
        self.require_affine = False
        self.require_backbone_point = False
        self.sc_node_name = ''
        self.pl_node_name = ''

    def _group(self, name, arguments, **datasets):
        self.groups[name] = {"arguments": list(arguments),
                             "datasets": dict(datasets), "attrs": {},
                             "subgroups": {}}
        return self.groups[name]

    # -- backbone covalent geometry (upside_config.py:480-526) -------------

    def add_backbone_springs(self, bond_stiffness=48.0, angle_stiffness=175.0,
                             omega_stiffness=30.0):
        n_atom = self.n_atom
        ids = np.arange(n_atom - 1)
        ids = np.column_stack([ids, ids + 1])
        equil = np.zeros(len(ids))
        equil[0::3] = 1.453
        equil[1::3] = 1.526
        equil[2::3] = 1.300
        self._group('dist_spring', ['pos'],
                    id=ids, equil_dist=equil,
                    spring_const=np.full(len(ids), bond_stiffness),
                    bonded_atoms=np.ones(len(ids), np.int32))

        ids = np.arange(n_atom - 2)
        ids = np.column_stack([ids, ids + 2, ids + 1])
        equil = np.zeros(len(ids))
        equil[0::3] = np.cos(109.5 * deg)
        equil[1::3] = np.cos(120.0 * deg)
        equil[2::3] = np.cos(120.0 * deg)
        self._group('angle_spring', ['pos'],
                    id=ids, equil_dist=equil,
                    spring_const=np.full(len(ids), angle_stiffness))

        ids = np.arange(1, n_atom - 3, 3)
        ids = np.column_stack([ids, ids + 1, ids + 2, ids + 3])
        target = np.where(self.seq_with_cpr[1:] == 'CPR', 0.0, np.pi)
        self._group('dihedral_spring', ['pos'],
                    id=ids, equil_dist=target,
                    spring_const=np.full(len(ids), omega_stiffness))
        return self

    # -- Rama (upside_config.py:855-863, 692-734) --------------------------

    def add_rama_coord(self):
        if 'rama_coord' in self.groups:
            return self
        n_res = self.n_res
        N_id = 3 * np.arange(n_res)
        ids = np.column_stack([N_id - 1, N_id, N_id + 1, N_id + 2, N_id + 3])
        ids[ids >= self.n_atom] = -1
        # chain breaks make terminal phi/psi dummy angles
        for start_atom in getattr(self, '_chain_starts', [])[1:]:
            r = int(start_atom) // 3
            ids[r, 0] = -1        # cut phi of the chain's first residue
            ids[r - 1, 4] = -1    # cut psi of the previous chain's last
        self._group('rama_coord', ['pos'], id=ids)
        return self

    def add_rama_map_pot(self, rama_pot, rama_map_id=None, center_maps=True):
        """rama_pot: (n_map, nx, ny) negative-log-prob maps; defaults to one
        map per residue."""
        rama_pot = np.asarray(rama_pot, np.float64)
        if rama_map_id is None:
            assert rama_pot.shape[0] == self.n_res
            rama_map_id = np.arange(self.n_res)
        if center_maps:
            # remove the Boltzmann-average energy of each map
            # (upside_config.py:727-730)
            rama_pot = rama_pot - (rama_pot * np.exp(-rama_pot)).sum(
                axis=(-2, -1), keepdims=True)
        self.require_rama = True
        self._group('rama_map_pot', ['rama_coord'],
                    residue_id=np.arange(self.n_res),
                    rama_map_id=np.asarray(rama_map_id, np.int32),
                    rama_pot=rama_pot)
        return self

    def add_rama_map_pot_from_library(self, library_path, sheet_mixing=None,
                                      mode='mixture'):
        pots = read_weighted_maps(list(self.seq_with_cpr), library_path,
                                  sheet_mixing, mode)
        return self.add_rama_map_pot(pots)

    def add_torus_dbn(self, torus_dbn_library):
        """TorusDBN Rama prior: von-Mises emission energies + fixed HMM
        over hidden states (upside_config.py:642-689)."""
        with h5.File(torus_dbn_library) as data:
            restype_order = [b.decode() if isinstance(b, bytes) else str(b)
                             for b in data['restype_order']]
            dbn_num = {x: i for i, x in enumerate(restype_order)}
            basin_param = np.asarray(data['basin_param'])
            aa_basin_energy = np.asarray(data['aa_basin_energy'])
            transition_energy = np.asarray(data['transition_energy'])
        restypes = np.array([dbn_num[s] for s in self.seq_with_cpr],
                            np.int32)
        self.require_rama = True
        # terminal residues have dummy Rama angles; keep them out of the HMM
        self._group('torus_dbn', ['rama_coord'],
                    id=np.arange(1, self.n_res - 1),
                    restypes=restypes[1:-1],
                    prior_offset_energies=aa_basin_energy,
                    basin_param=basin_param)
        self._group('fixed_hmm', ['torus_dbn'],
                    index=np.arange(self.n_res - 2),
                    transition_energy=transition_energy)
        return self

    # -- rigid-frame machinery (upside_config.py:149-185, 795-812) ---------

    def add_affine_alignment(self):
        if 'affine_alignment' in self.groups:
            return self
        n_res = self.n_res
        ref = np.array([REF_N, REF_CA, REF_C])
        ref = ref - ref.mean(0)
        atoms = np.column_stack([3 * np.arange(n_res), 3 * np.arange(n_res) + 1,
                                 3 * np.arange(n_res) + 2])
        self._group('affine_alignment', ['pos'],
                    atoms=atoms, ref_geom=np.tile(ref, (n_res, 1, 1)))
        return self

    def add_backbone_pairs(self):
        n_res = self.n_res
        ref_pos = np.zeros((n_res, 4, 3))
        ref_pos[:, 0] = REF_N
        ref_pos[:, 1] = REF_CA
        ref_pos[:, 2] = REF_C
        ref_pos[:, 3] = REF_CB
        ref_pos[self.fasta == 'GLY', 3] = np.nan
        ref_pos -= ref_pos[:, :3].mean(axis=1)[:, None]
        n_atom = np.isfinite(ref_pos.sum(-1)).sum(-1)
        self.require_affine = True
        self._group('backbone_pairs', ['affine_alignment'],
                    id=np.arange(n_res), ref_pos=ref_pos, n_atom=n_atom)
        return self

    def add_CB_placement(self):
        if 'placement_fixed_point_only_CB' in self.groups:
            return self
        ref = np.array([REF_N, REF_CA, REF_C, REF_CB])
        ref = ref - ref[:3].mean(0, keepdims=True)
        self.require_affine = True
        self._group('placement_fixed_point_only_CB', ['affine_alignment'],
                    affine_residue=np.arange(self.n_res),
                    layer_index=np.zeros(self.n_res, np.int32),
                    placement_data=ref[3][None, :])
        return self

    # -- hydrogen bonding (upside_config.py:187-213, 295-380) --------------

    def add_hbond(self, hbond_energy, exclude_residues=(), loose=False,
                  coverage_library=None):
        n_res = self.n_res
        excluded = set(int(x) for x in exclude_residues)
        donor_res = np.array([i for i in range(n_res)
                              if i > 0 and i not in excluded
                              and self.fasta[i] != 'PRO'])
        acceptor_res = np.array([i for i in range(n_res)
                                 if i < n_res - 1 and i not in excluded])
        g = self._group('infer_H_O', ['pos'])
        g['subgroups']['donors'] = {
            'residue': donor_res,
            'bond_length': 0.88 * np.ones(len(donor_res)),
            'id': np.array((-1, 0, 1))[None, :] + 3 * donor_res[:, None]}
        g['subgroups']['acceptors'] = {
            'residue': acceptor_res,
            'bond_length': 1.24 * np.ones(len(acceptor_res)),
            'id': np.array((1, 2, 3))[None, :] + 3 * acceptor_res[:, None]}

        nd, na = len(donor_res), len(acceptor_res)
        iparam = np.array([[[
            0.5 if loose else 1.4, 1.0 / 0.10,
            3.1 if loose else 2.5, 1.0 / 0.125,
            0.182 if loose else 0.682, 1.0 / 0.05,
            0.0, 0.0]]])
        self._group('protein_hbond', ['infer_H_O'],
                    index1=np.arange(nd), type1=np.zeros(nd, np.int32),
                    id1=donor_res,
                    index2=nd + np.arange(na), type2=np.zeros(na, np.int32),
                    id2=acceptor_res,
                    interaction_param=iparam)

        if self.sc_node_name and coverage_library is not None:
            with h5.File(coverage_library) as lib:
                coverage_interaction = np.asarray(lib['coverage_interaction'])
                bead_order = [b.decode() if isinstance(b, bytes) else str(b)
                              for b in lib['bead_order']]
                hydrophobe_placement = np.asarray(lib['hydrophobe_placement'])
                hydrophobe_interaction = np.asarray(
                    lib['hydrophobe_interaction'])
            bead_num = {k: i for i, k in enumerate(bead_order)}
            sc = self.groups[self.sc_node_name]['datasets']
            rseq = [s.decode() if isinstance(s, bytes) else str(s)
                    for s in sc['beadtype_seq']]
            sc_resnum = sc['affine_residue']
            self._group('hbond_coverage',
                        ['protein_hbond', self.sc_node_name],
                        interaction_param=coverage_interaction,
                        index1=np.arange(nd + na),
                        type1=(np.arange(nd + na) >= nd).astype(np.int32),
                        id1=np.concatenate([donor_res, acceptor_res]),
                        index2=np.arange(len(rseq)),
                        type2=np.array([bead_num[s] for s in rseq], np.int32),
                        id2=sc_resnum)
            self._group('placement_fixed_point_vector_scalar',
                        ['affine_alignment'],
                        affine_residue=np.arange(3 * n_res) // 3,
                        layer_index=np.arange(3 * n_res) % 3,
                        placement_data=hydrophobe_placement)
            self._group('hbond_coverage_hydrophobe',
                        ['placement_fixed_point_vector_scalar',
                         self.sc_node_name],
                        interaction_param=hydrophobe_interaction,
                        index1=np.arange(3 * n_res),
                        type1=(np.arange(3 * n_res) % 3).astype(np.int32),
                        id1=np.arange(3 * n_res) // 3,
                        index2=np.arange(len(rseq)),
                        type2=np.array([bead_num[s] for s in rseq], np.int32),
                        id2=sc_resnum)

        g = self._group('hbond_energy', ['protein_hbond'])
        g['attrs']['protein_hbond_energy'] = float(hbond_energy)
        return self

    # -- rotamer sidechains (upside_config.py:885-1035) --------------------

    def add_rotamer_sidechains(self, placement_library, interaction_library,
                               damping=0.4, dynamic_1body=True,
                               fix_rotamer=None):
        with h5.File(placement_library) as data:
            restype_order = [b.decode() if isinstance(b, bytes) else str(b)
                             for b in data['restype_order']]
            restype_num = {aa: i for i, aa in enumerate(restype_order)}
            placement_pos = np.asarray(data['rotamer_center_fixed'])
            if dynamic_1body:
                placement_energy = -np.log(np.asarray(
                    data['rotamer_prob']).transpose(2, 0, 1))[..., None]
            else:
                placement_energy = np.asarray(
                    data['rotamer_prob_fixed'])[..., None]
            start_stop = np.asarray(data['rotamer_start_stop_bead'])

        rama_residue, affine_residue, layer_index = [], [], []
        beadtype_seq, id_seq = [], []
        count_by_n_rot: Dict[int, int] = {}
        fix = dict(fix_rotamer or {})

        for rnum, aa in enumerate(self.fasta):
            restype = restype_num[aa]
            start, stop, n_bead = start_stop[restype]
            assert (stop - start) % n_bead == 0
            n_rot = (stop - start) // n_bead
            if rnum in fix:
                start, stop = (start + n_bead * fix[rnum],
                               start + n_bead * (fix[rnum] + 1))
                n_rot = 1
            count_by_n_rot.setdefault(n_rot, 0)
            base_id = (count_by_n_rot[n_rot] << N_BIT_ROTAMER) + n_rot
            count_by_n_rot[n_rot] += 1
            rama_residue.extend([rnum] * (stop - start))
            affine_residue.extend([rnum] * (stop - start))
            layer_index.extend(range(start, stop))
            beadtype_seq.extend([f'{aa}_{i}' for i in range(n_bead)] * n_rot)
            id_seq.extend(np.arange(stop - start) // n_bead +
                          (base_id << N_BIT_ROTAMER))

        self.require_rama = True
        self.require_affine = True
        self.sc_node_name = 'placement_fixed_point_vector_only'
        self._group(self.sc_node_name, ['affine_alignment'],
                    rama_residue=np.asarray(rama_residue),
                    affine_residue=np.asarray(affine_residue),
                    layer_index=np.asarray(layer_index),
                    placement_data=placement_pos[..., :6],
                    beadtype_seq=np.asarray(beadtype_seq, dtype='S'),
                    id_seq=np.asarray(id_seq))

        self.pl_node_name = ('placement_scalar' if dynamic_1body
                             else 'placement_fixed_scalar')
        args = ['affine_alignment'] + (['rama_coord'] if dynamic_1body else [])
        self._group(self.pl_node_name, args,
                    rama_residue=np.asarray(rama_residue),
                    affine_residue=np.asarray(affine_residue),
                    layer_index=np.asarray(layer_index),
                    placement_data=placement_energy)

        with h5.File(interaction_library) as data:
            pair_interaction = np.asarray(data['pair_interaction'])
            bead_order = [b.decode() if isinstance(b, bytes) else str(b)
                          for b in data['bead_order']]
        bead_num = {k: i for i, k in enumerate(bead_order)}

        self._interaction_library = interaction_library
        self._rotamer_damping = damping
        self._rotamer_pair = {
            'interaction_param': pair_interaction,
            'index': np.arange(len(beadtype_seq)),
            'type': np.array([bead_num[s] for s in beadtype_seq], np.int32),
            'id': np.asarray(id_seq)}
        return self

    def add_rotamer_node(self):
        args = [self.sc_node_name, self.pl_node_name]
        for nm in ('hbond_coverage', 'hbond_coverage_hydrophobe'):
            if nm in self.groups:
                args.append(nm)
        g = self._group('rotamer', args)
        g['attrs'].update(max_iter=1000, tol=1e-3,
                          damping=self._rotamer_damping,
                          iteration_chunk_size=2)
        g['subgroups']['pair_interaction'] = dict(self._rotamer_pair)
        return self

    # -- environment / burial (upside_config.py:215-292) -------------------

    def add_environment(self, environment_library):
        with h5.File(environment_library) as lib:
            energies = np.asarray(lib['energies'])
            offset = float(lib['energies'].attrs['offset'])
            inv_dx = float(lib['energies'].attrs['inv_dx'])
            restype_order = [b.decode() if isinstance(b, bytes) else str(b)
                             for b in lib['restype_order']]
            coverage_param = np.asarray(lib['coverage_param'])
        restype_num = {aa: i for i, aa in enumerate(restype_order)}

        ref = np.array([REF_N, REF_CA, REF_C, REF_CB])
        # NOTE: reproduces the reference's acknowledged centering quirk
        # (mean over all 4 atoms, upside_config.py:235-239) because shipped
        # parameters were trained with it
        ref = ref - ref.mean(0, keepdims=True)
        pdata = np.zeros((1, 6))
        pdata[0, 0:3] = ref[3]
        pdata[0, 3:6] = (ref[3] - ref[2]) / np.linalg.norm(ref[3] - ref[2])

        self.require_affine = True
        self._group('placement_fixed_point_vector_only_CB',
                    ['affine_alignment'],
                    affine_residue=np.arange(self.n_res),
                    layer_index=np.zeros(self.n_res, np.int32),
                    placement_data=pdata)

        sc = self.groups[self.sc_node_name]['datasets']
        n_sc = len(sc['affine_residue'])
        self._group('weighted_pos', [self.sc_node_name, self.pl_node_name],
                    index_pos=np.arange(n_sc), index_weight=np.arange(n_sc))

        self._group('environment_coverage',
                    ['placement_fixed_point_vector_only_CB', 'weighted_pos'],
                    index1=np.arange(self.n_res),
                    type1=np.array([restype_num[s] for s in self.fasta],
                                   np.int32),
                    id1=np.arange(self.n_res),
                    index2=np.arange(n_sc),
                    type2=np.zeros(n_sc, np.int32),
                    id2=np.asarray(sc['affine_residue']),
                    interaction_param=coverage_param)

        g = self._group('nonlinear_coupling_environment',
                        ['environment_coverage'],
                        coeff=energies,
                        coupling_types=np.array(
                            [restype_num[s] for s in self.fasta], np.int32))
        g['attrs']['coeff:spline_offset'] = offset
        g['attrs']['coeff:spline_inv_dx'] = inv_dx
        return self

    # -- simple extras ------------------------------------------------------

    def add_cavity_radial(self, radius, spring_constant=5.0):
        self._group('cavity_radial', ['pos'],
                    id=np.arange(self.n_atom),
                    radius=np.full(self.n_atom, radius),
                    spring_constant=np.full(self.n_atom, spring_constant))
        return self

    def add_contacts(self, ids, energy, distance, width):
        self.require_backbone_point = True
        self._group('contact', ['placement_fixed_point_only_CB'],
                    id=np.asarray(ids, np.int32), energy=np.asarray(energy),
                    distance=np.asarray(distance), width=np.asarray(width))
        return self

    def add_sidechain_radial(self, library_path, exclude_residues=(),
                             suffix=''):
        excluded = set(int(x) for x in exclude_residues)
        residues = sorted(set(range(self.n_res)) - excluded)
        with h5.File(library_path) as params:
            names = [b.decode() if isinstance(b, bytes) else str(b)
                     for b in params['names']]
            iparam = np.asarray(params['interaction_param'])
        rnum = {x: i for i, x in enumerate(names)}
        self.require_backbone_point = True
        self._group('radial' + suffix, ['placement_fixed_point_only_CB'],
                    index=np.asarray(residues),
                    type=np.array([rnum[self.fasta[i]] for i in residues],
                                  np.int32),
                    id=np.asarray(residues),
                    interaction_param=iparam)
        return self

    def add_target_structure(self, target_pos):
        """Record a target structure under /target for later analysis
        (upside_config.py:1380-1387, py/add_target_information.py); never
        read by the engine."""
        self._target = np.asarray(target_pos, np.float32)
        return self

    def add_z_flat_bottom(self, entries):
        """entries: list of (residue, z0, radius, spring_constant); the
        restraint acts on each residue's CA atom (upside_config.py:46-79)."""
        entries = np.asarray(entries, np.float64)
        self._group('z_flat_bottom', ['pos'],
                    atom=(entries[:, 0].astype(np.int32) * 3 + 1),
                    z0=entries[:, 1], radius=entries[:, 2],
                    spring_constant=entries[:, 3])
        return self

    def add_tension(self, entries):
        """entries: list of (residue, tx, ty, tz) pulls on CA atoms."""
        entries = np.asarray(entries, np.float64)
        self._group('tension', ['pos'],
                    atom=(entries[:, 0].astype(np.int32) * 3 + 1),
                    tension_coeff=entries[:, 1:4])
        return self

    def add_afm(self, entries, time_initial=0.0, time_step=0.009):
        """entries: (residue, spring_const, tip_xyz(3), pulling_vel(3))."""
        entries = np.asarray(entries, np.float64)
        g = self._group('AFM', ['pos'],
                        atom=(entries[:, 0].astype(np.int32) * 3 + 1),
                        spring_const=entries[:, 1],
                        starting_tip_pos=entries[:, 2:5],
                        pulling_vel=entries[:, 5:8])
        g['attrs']['pulling_vel:time_initial'] = float(time_initial)
        g['attrs']['pulling_vel:time_step'] = float(time_step)
        return self

    def add_restraint_group(self, residues, strength=4.0, group_num=0):
        """Random-pairing distance restraints within a residue group,
        with equilibrium distances from the initial structure
        (upside_config.py:383-411; same deterministic seed)."""
        if 'dist_spring' not in self.groups:
            raise ValueError('add_backbone_springs must run first')
        np.random.seed(314159)
        ds = self.groups['dist_spring']['datasets']
        r_atoms = np.array([(3 * i, 3 * i + 1, 3 * i + 2)
                            for i in sorted(residues)]).reshape(-1)
        pairs = np.concatenate(
            [np.column_stack([r_atoms, np.random.permutation(r_atoms)])
             for _ in range(2)], axis=0)
        pairs = [((x, y) if x < y else (y, x)) for x, y in pairs
                 if x // 3 != y // 3]
        pairs = np.array(sorted(set(pairs)))
        dists = np.linalg.norm(self.pos[pairs[:, 0]] - self.pos[pairs[:, 1]],
                               axis=-1)
        ds['id'] = np.concatenate([ds['id'], pairs])
        ds['equil_dist'] = np.concatenate([ds['equil_dist'], dists])
        ds['spring_const'] = np.concatenate(
            [ds['spring_const'], np.full(len(pairs), strength)])
        ds['bonded_atoms'] = np.concatenate(
            [ds['bonded_atoms'], np.zeros(len(pairs), np.int32)])
        return self

    def add_membrane_potential(self, membrane_library, membrane_thickness,
                               membrane_exclude_residues=(),
                               hbond_exclude_residues=()):
        """Membrane z-profile potential, rescaled to the requested
        thickness exactly as the reference does
        (upside_config.py:1038-1149)."""
        import scipy.interpolate

        with h5.File(membrane_library) as lib:
            resnames = [b.decode() if isinstance(b, bytes) else str(b)
                        for b in lib['names']]
            cb_energy = np.asarray(lib['cb_energy'])
            cb_z_min = float(lib['cb_energy'].attrs['z_min'])
            cb_z_max = float(lib['cb_energy'].attrs['z_max'])
            thickness = float(lib['cb_energy'].attrs['thickness'])
            uhb_energy = np.asarray(lib['uhb_energy'])
            uhb_z_min = float(lib['uhb_energy'].attrs['z_min'])
            uhb_z_max = float(lib['uhb_energy'].attrs['z_max'])
            cov_midpoint = np.asarray(lib['cov_midpoint'])
            cov_sharpness = np.asarray(lib['cov_sharpness'])

        # Thickness rescale contract (pinned by tests): each leaflet's
        # z-profile translates rigidly toward/away from z=0 by half the
        # thickness difference.  Thicker target: the gap at the center is
        # filled with the library's midplane value.  Thinner target: the
        # leaflets overlap, and the mismatch at z=0 is split symmetrically
        # so the profile stays continuous there.  Beyond the library range
        # the profile extends flat.  Same observable behavior as
        # upside_config.py:1064-1120.
        def eval_flat_ends(energies, z_lib, zq):
            """Evaluate every profile (cubic interpolating spline) at the
            query points, clamped to the boundary values outside."""
            zc = np.clip(zq, z_lib[0], z_lib[-1])
            return np.stack([
                scipy.interpolate.InterpolatedUnivariateSpline(z_lib, e)(zc)
                for e in energies])

        def rescale(energies, z_lib):
            half_t, half_lib = membrane_thickness / 2.0, thickness / 2.0
            z = np.linspace(-half_t - 15.0, half_t + 15.0,
                            int((membrane_thickness + 30.0) / 0.25) + 1)
            shift = half_lib - half_t
            if shift > 0:       # thinner target: overlapping leaflets
                zq = z + np.where(z < 0, -shift, shift)
                out = eval_flat_ends(energies, z_lib, zq)
                ends = eval_flat_ends(energies, z_lib,
                                      np.array([shift, -shift]))
                dsym = (ends[:, 0] - ends[:, 1])[:, None]
                out += np.where(z < 0, 0.5, -0.5) * dsym
            elif shift < 0:     # thicker target: flat midplane infill
                zq = np.clip(np.abs(z) + shift, 0.0, None) * np.sign(z)
                out = eval_flat_ends(energies, z_lib, zq)
            else:
                out = eval_flat_ends(energies, z_lib, z)
            return out, z

        cb_z_lib = np.linspace(cb_z_min, cb_z_max, cb_energy.shape[-1])
        uhb_z_lib = np.linspace(uhb_z_min, uhb_z_max, uhb_energy.shape[-1])
        cb_out, z = rescale(cb_energy, cb_z_lib)
        uhb_out, _ = rescale(uhb_energy, uhb_z_lib)

        n_res = self.n_res
        hbx = set(int(x) for x in hbond_exclude_residues)
        donor_ids = np.array([i for i in range(n_res)
                              if i > 0 and i not in hbx
                              and self.fasta[i] != 'PRO'])
        acceptor_ids = np.array([i for i in range(n_res)
                                 if i < n_res - 1 and i not in hbx])

        sequence = list(self.fasta)
        for num in membrane_exclude_residues:
            sequence[int(num)] = 'NON'
        rnum = {aa: i for i, aa in enumerate(resnames)}
        self.require_backbone_point = True
        g = self._group('membrane_potential',
                        ['placement_fixed_point_only_CB',
                         'environment_coverage', 'protein_hbond'],
                        cb_index=np.arange(n_res),
                        env_index=np.arange(n_res),
                        residue_type=np.array([rnum[s] for s in sequence],
                                              np.int32),
                        cov_midpoint=cov_midpoint,
                        cov_sharpness=cov_sharpness,
                        cb_energy=cb_out, uhb_energy=uhb_out,
                        donor_residue_ids=donor_ids,
                        acceptor_residue_ids=acceptor_ids)
        g['attrs']['cb_energy:z_min'] = z[0]
        g['attrs']['cb_energy:z_max'] = z[-1]
        g['attrs']['uhb_energy:z_min'] = z[0]
        g['attrs']['uhb_energy:z_max'] = z[-1]
        return self

    def add_chain_breaks(self, chain_first_residue, rl_chains=None,
                         jump_length_scale=5.0, jump_rotation_scale=30.0):
        """Multichain setup: remove bonded terms that cross chain breaks,
        cut terminal Rama angles at the breaks, and add rigid-chain jump
        moves.  (The reference implements this as a config post-processing
        tool, py/ugly_hack_break_chain.py; the hbond exclusion near breaks
        must still be passed to add_hbond as exclude_residues.)"""
        chain_first_residue = [int(x) for x in chain_first_residue]
        starts = np.array([0] + chain_first_residue) * 3
        n_chains = len(starts)
        self.extra_input['chain_break'] = {
            'chain_first_residue': np.asarray(chain_first_residue, np.int32)}
        if rl_chains is not None:
            self.extra_input['chain_break']['rl_chains'] = \
                np.asarray(rl_chains, np.int32)

        def chain_of(ids):
            return (np.asarray(ids)[..., None] >= starts[None, :]).sum(-1)

        def multichain_rows(ids):
            c = chain_of(ids)
            return np.array([len(set(row)) > 1 for row in c])

        for name in ('dist_spring', 'angle_spring', 'dihedral_spring'):
            if name not in self.groups:
                continue
            ds = self.groups[name]['datasets']
            bad = multichain_rows(ds['id'])
            if name == 'dist_spring':
                bad = bad & ds['bonded_atoms'].astype(bool)
            keep = ~bad
            for k in list(ds):
                ds[k] = ds[k][keep]

        # jump moves: one rigid body per chain (or receptor/ligand groups)
        ends = np.append(starts, self.n_atom)
        if rl_chains is None:
            atom_range = np.array([[ends[i], ends[i + 1]]
                                   for i in range(n_chains)], np.int32)
        else:
            atom_range = np.array(
                [[ends[0], ends[rl_chains[0]]],
                 [ends[rl_chains[0]], ends[-1]]], np.int32)
        self.extra_input['jump_moves'] = {
            'atom_range': atom_range,
            'sigma_trans': np.full(len(atom_range), jump_length_scale,
                                   np.float32),
            'sigma_rot': np.full(len(atom_range),
                                 jump_rotation_scale * deg, np.float32)}
        self._chain_starts = starts
        return self

    def finalize(self):
        if self.require_backbone_point:
            self.require_affine = True
            self.add_CB_placement()
        if self.require_rama:
            self.add_rama_coord()
        if self.require_affine:
            self.add_affine_alignment()
        # pivot proposal tables from the Rama pot itself
        # (upside_config.py:1660-1669)
        if self.require_rama and 'rama_map_pot' in self.groups:
            rc = self.groups['rama_coord']['datasets']['id']
            non_terminal = ~np.any(rc == -1, axis=1)
            rmp = self.groups['rama_map_pot']['datasets']
            self.extra_input['pivot_moves'] = {
                'proposal_pot': rmp['rama_pot'],
                'pivot_atom': rc[non_terminal],
                'pivot_restype': rmp['rama_map_id'][non_terminal],
                'pivot_range': np.column_stack(
                    [rc[non_terminal, 4] + 1,
                     np.full(non_terminal.sum(), self.n_atom, np.int32)])}
        return self

    # -- output -------------------------------------------------------------

    def write(self, path, args=None):
        """Finalize and write the `.up` file at `path`; `args`, where
        given, are the attributes of an /input/args group (the command
        line's flag archive, config/cli.py)."""
        self.finalize()
        with h5.Writer(path) as w:
            w.create_group('input')
            w.create_dataset('input/sequence',
                             np.asarray(self.seq_with_cpr, dtype='S'))
            w.create_dataset('input/pos', self.pos[:, :, None])
            w.create_group('input/potential')
            for name, g in self.groups.items():
                at = f'input/potential/{name}'
                attrs = {'arguments': np.asarray(g['arguments'], dtype='S')}
                ds_attrs: Dict[str, Dict] = {}
                for k, v in g['attrs'].items():
                    if ':' in k:  # dataset-level attr "dset:attr"
                        ds, attr = k.split(':')
                        ds_attrs.setdefault(ds, {})[attr] = v
                    else:
                        attrs[k] = v
                w.create_group(at, attrs)
                for k, v in g['datasets'].items():
                    w.create_dataset(f'{at}/{k}', v, ds_attrs.get(k))
                for sub_name, sub in g['subgroups'].items():
                    w.create_group(f'{at}/{sub_name}')
                    for k, v in sub.items():
                        w.create_dataset(f'{at}/{sub_name}/{k}', v)
            for name, g in self.extra_input.items():
                w.create_group(f'input/{name}')
                for k, v in g.items():
                    w.create_dataset(f'input/{name}/{k}', v)
            if args is not None:
                w.create_group('input/args', args)
            if getattr(self, '_target', None) is not None:
                w.create_group('target')
                w.create_dataset('target/pos', self._target)
        return path


# -- rama dimer library ------------------------------------------------------
# Semantic contract (pinned by tests/test_rama_library.py): every interior
# residue's map combines its two dimer contexts, either as the free energy
# of a weight-Boltzmann mixture or by the product rule; terminal residues
# take their single context; every map is normalized to unit partition.
# Same observable behavior as the reference config generator
# (upside_config.py:567-639); formulated here as vectorized table lookups.

def mixture_potential(weights, potentials):
    """Free energy of a Boltzmann mixture of component free energies:
    -log sum_k w_k exp(-F_k) with the component weights normalized, via a
    max-shifted (stable) logsumexp."""
    F = np.asarray(potentials, np.float64)
    w = np.asarray(weights, np.float64)
    logw = np.log(w / w.sum(axis=0))
    a = logw.reshape(logw.shape + (1,) * (F.ndim - logw.ndim)) - F
    amax = a.max(axis=0)
    return -(amax + np.log(np.exp(a - amax).sum(axis=0)))


def read_rama_maps_and_weights(seq, rama_group, mode='mixture',
                               allow_CPR=True):
    """Per-residue (n_res, nx, ny) Rama maps from a dimer library group.

    The library tabulates dimer maps pot[center, dir, neighbor]; cis-Pro
    ('CPR') centers fall back to 'PRO' unless the library distinguishes
    them (allow_CPR); CPR as a *neighbor* always reads as 'PRO'."""
    assert len(seq) >= 3
    names = [b.decode() if isinstance(b, bytes) else str(b)
             for b in rama_group.attrs['restype']]
    dirs = [b.decode() if isinstance(b, bytes) else str(b)
            for b in rama_group.attrs['dir']]
    index = {name: i for i, name in enumerate(names)}
    LEFT, RIGHT = dirs.index('left'), dirs.index('right')

    def as_center(r):
        return index['PRO' if (r == 'CPR' and not allow_CPR) else r]

    center = np.array([as_center(r) for r in seq])
    nbr = np.array([index['PRO' if r == 'CPR' else r] for r in seq])

    pot = np.asarray(rama_group['dimer_pot'])
    wgt = np.asarray(rama_group['dimer_weight'])
    # right-context of residues 0..n-2 and left-context of residues 1..n-1
    Vr, Wr = pot[center[:-1], RIGHT, nbr[1:]], wgt[center[:-1], RIGHT, nbr[1:]]
    Vl, Wl = pot[center[1:], LEFT, nbr[:-1]], wgt[center[1:], LEFT, nbr[:-1]]

    n = len(seq)
    pots = np.empty((n,) + pot.shape[-2:], dtype='f4')
    weights = np.empty(n, dtype='f4')
    pots[0], weights[0] = Vr[0], Wr[0]
    pots[-1], weights[-1] = Vl[-1], Wl[-1]
    # interior residue i: left context Vl[i-1], right context Vr[i]
    left_V, left_W = Vl[:-1], Wl[:-1]
    right_V, right_W = Vr[1:], Wr[1:]
    if mode == 'product':
        marginal = pot[center[1:-1], RIGHT, index['ALL']]
        pots[1:-1] = left_V + right_V - marginal
    else:
        pots[1:-1] = mixture_potential(np.stack([left_W, right_W]),
                                       np.stack([left_V, right_V]))
    weights[1:-1] = 0.5 * (left_W + right_W)
    # normalize each residue's map to a unit partition function
    pots += np.log(np.exp(-pots).sum(axis=(-2, -1), keepdims=True))
    return pots, weights


def read_weighted_maps(seq, rama_library_h5, sheet_mixing=None,
                       mode='mixture'):
    """Coil maps, optionally Boltzmann-mixed with sheet maps whose weights
    are scaled by exp(-sheet_mixing) (upside_config.py:627-639)."""
    with h5.File(rama_library_h5) as tr:
        coil_pots, coil_weights = read_rama_maps_and_weights(
            seq, tr['coil'], mode=mode)
        if sheet_mixing is None:
            return coil_pots
        sheet_pots, sheet_weights = read_rama_maps_and_weights(
            seq, tr['sheet'], allow_CPR=False)
    return mixture_potential(
        np.stack([coil_weights, sheet_weights * np.exp(-sheet_mixing)]),
        np.stack([coil_pots, sheet_pots]))


def apply_secstr_bias(rama_pot, entries):
    """Secondary-structure bias via Rama-basin energies
    (upside_config.py:705-725).  entries: (residue, 'helix'|'sheet',
    energy)."""
    rama_pot = np.array(rama_pot, np.float64)
    phi = np.linspace(-np.pi, np.pi, rama_pot.shape[1],
                      endpoint=False)[:, None]
    psi = np.linspace(-np.pi, np.pi, rama_pot.shape[2],
                      endpoint=False)[None, :]

    def sig_lt(a, b):
        return 1.0 / (1.0 + np.exp(-(b - a) / (10.0 * deg)))

    helical = sig_lt(phi, 0.0) * sig_lt(-100.0 * deg, psi) * \
        sig_lt(psi, 50.0 * deg)
    sheet = sig_lt(phi, 0.0) * (sig_lt(psi, -100.0 * deg) +
                                sig_lt(50.0 * deg, psi))
    for residue, secstr, energy in entries:
        basin = {'helix': helical, 'sheet': sheet}[secstr]
        rama_pot[int(residue)] += float(energy) * basin
    return rama_pot


def uniform_rama_maps_from_reference(n_res, pickle_path):
    """Fallback Rama maps when no dimer library is available: the shared
    (72,72) reference map for every residue."""
    ref = np.asarray(pickle.load(open(pickle_path, 'rb'),
                                 encoding='latin1'), np.float64)
    return np.tile(ref[None], (n_res, 1, 1))
