"""Chi1 rotamer-state prediction (port of upside_md_tpu/chi1.py; reference
py/predict_chi1.py): BASELINE config 5.

The prediction config (loose hbond criteria, dynamic rotamer 1-body, no
backbone sterics or springs, hbond energy -1e-5) is built on the machine
with jax and exported as a bundle whose aux section `chi1` carries the
sidechain library's `restype_order` and `restype_and_chi_and_state`
table and the sequence (`tools/export_torch_bundle.py`).  Here one
evaluation over a batch of configurations gives the sensitivities of the
`hbond_coverage` output, which are the posterior bead marginals by the
envelope theorem, and the library table maps them to chi1-bin
probabilities per residue.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .config import bundle
from .io import h5
from .system import System

deg = np.pi / 180.0
FIXED = ("ALA", "GLY")    # residues without chi1: bin 0 with certainty


def compute_chi1_state(chi1):
    return (((chi1 / deg) % 360.0) / 120.0).astype('i')


class Chi1Predict:
    """Map rotamer-state posteriors to chi1-bin probabilities.

    `restype_and_chi_and_state` rows are [restype, chi1, ..., state]: each
    library rotamer state of a restype has a chi1 angle, and the states
    bucket into the three 120-degree chi1 wells, a dense lookup
    state_to_bin[restype, state] (chi1.py:20-57 of the JAX package)."""

    def __init__(self, restype_order, restype_and_chi_and_state):
        order = [b.decode() if isinstance(b, bytes) else str(b)
                 for b in restype_order]
        self.restype_dict = {x: i for i, x in enumerate(order)}
        self.n_restype = len(self.restype_dict)
        self.restype_dict['CPR'] = self.restype_dict['PRO']
        table = np.asarray(restype_and_chi_and_state)
        rt = table[:, 0].astype(int)
        state = table[:, -1].astype(int)
        self.n_state = int(state.max()) + 1
        self.state_to_bin = np.full((self.n_restype, self.n_state), -1,
                                    dtype=int)
        self.state_to_bin[rt, state] = compute_chi1_state(table[:, 1])

    @classmethod
    def from_aux(cls, aux):
        """From a bundle's `chi1` aux section."""
        return cls(aux["restype_order"], aux["restype_and_chi_and_state"])

    @classmethod
    def from_library(cls, path):
        """From a sidechain library's HDF5 file, read without h5py, as the
        JAX package's `Chi1Predictor(sidechain_file)` reads it
        (chi1.py:35-56)."""
        with h5.File(path) as f:
            return cls(f["restype_order"][()],
                       f["restype_and_chi_and_state"][()])

    def bead_bins(self, seq, residue):
        """Each bead's chi1 bin, its library state being its rank within
        its residue (beads of a residue appear in state order); a state
        without a bin counts in bin 2, as the JAX package's np.add.at at
        index -1 does."""
        residue = np.asarray(residue)
        res_rt = np.array([self.restype_dict[aa] for aa in seq])
        first = np.concatenate([[0], np.flatnonzero(np.diff(residue)) + 1])
        slot = np.arange(len(residue)) - first[
            np.searchsorted(residue[first], residue)]
        return self.state_to_bin[res_rt[residue], slot] % 3

    def predict_chi1(self, seq, residue, rotamer_posterior_prob):
        """seq: 3-letter sequence; residue: per-bead residue index;
        posterior (n_bead,) or (B, n_bead), numpy or a tensor on any
        device.  Returns float32 chi1-bin probabilities (n_res, 3) or (B,
        n_res, 3) of the same kind."""
        is_tensor = isinstance(rotamer_posterior_prob, torch.Tensor)
        prob = torch.as_tensor(rotamer_posterior_prob).to(torch.float32)
        one = prob.dim() == 1
        prob = prob.reshape(-1, prob.shape[-1])
        n_res = len(seq)
        cell = torch.as_tensor(np.asarray(residue) * 3
                               + self.bead_bins(seq, residue),
                               device=prob.device)
        out = prob.new_zeros((prob.shape[0], n_res * 3)).index_add_(
            1, cell, prob).reshape(-1, n_res, 3)
        fixed = torch.as_tensor(np.isin(np.asarray(seq), FIXED),
                                device=prob.device)
        out[:, fixed] = torch.tensor([1.0, 0.0, 0.0], device=prob.device)
        out = out[0] if one else out
        return out if is_tensor else out.numpy()

    def compute_zero_one_stats(self, seq, chi1_prob, chi1_states):
        """Per restype (hits, residues): the argmax bin against the true
        chi1 states (chi1.py:74-82)."""
        rt = np.array([self.restype_dict[aa] for aa in seq])
        hit = (np.argmax(np.asarray(chi1_prob), axis=1) ==
               np.asarray(chi1_states)).astype('i8')
        results = np.zeros((self.n_restype, 2), dtype='i8')
        np.add.at(results[:, 0], rt, hit)
        np.add.at(results[:, 1], rt, 1)
        return results


def predict_chi1_from_bundle(path, device="cuda", pos=None,
                             dtype=torch.float32):
    """Chi1 prediction on a prediction-config bundle, as
    `predict_chi1_from_pdb` does after it has built its config
    (chi1.py:108-121): the per-bead residue of the sidechain placement,
    `get_sens(pos, "hbond_coverage")[..., 0]`, and the bin mapping.  `pos`
    is a batch of configurations (B, n_atom, 3) or one (n_atom, 3); by
    default the bundle's initial structure.  Runs on the card unless
    `device` says otherwise.  Returns (chi1 probabilities (B, n_res, 3)
    tensor, sequence, seconds of the evaluation)."""
    system, pos0 = System.from_bundle(path, device, dtype)
    aux = bundle.load_aux(path)["chi1"]
    predictor = Chi1Predict.from_aux(aux)
    seq = [str(s) for s in aux["sequence"]]
    residue = system.consts["placement_fixed_point_vector_only"][
        "affine_residue"].cpu().numpy()
    x = pos0 if pos is None else torch.as_tensor(pos, dtype=dtype,
                                                  device=system.device)
    x = x[None] if x.dim() == 2 else x
    t0 = time.perf_counter()
    sens = system.get_sens(x, "hbond_coverage")[..., 0]
    if sens.is_cuda:
        torch.cuda.synchronize(sens.device)
    elapsed = time.perf_counter() - t0
    return predictor.predict_chi1(seq, residue, sens), seq, elapsed
