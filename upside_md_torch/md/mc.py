"""Monte Carlo move samplers over a replica batch (port of
upside_md_tpu/md/mc.py; reference src/monte_carlo_sampler.cpp).

* PivotSampler: each replica draws a (phi, psi) bin from its pivot
  residue's Rama proposal distribution and rigidly rotates the downstream
  chain about the phi (CA-N) and psi (C-CA) axes.
* JumpSampler: rigid translation or rotation of a whole chain.

A Metropolis step makes two cold-started energy evaluations and accepts or
reverts each replica with `torch.where`, on the device.  The random draws
come from a `torch.Generator`, or are handed in: the layout of each
sampler's `draw` is what its `propose` reads, and the parity tests fill it
with the JAX package's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.geometry import (axis_angle_to_rot, dihedral, normalized,
                            rotate_vec)


def _rows(pos, atom):
    """pos (B, n, 3) at per-replica atom indices (B,) -> (B, 3)."""
    return pos[torch.arange(pos.shape[0], device=pos.device), atom]


@dataclass
class PivotSampler:
    rama_atom: torch.Tensor     # (n_pivot, 5) prevC, N, CA, C, nextN
    pivot_range: torch.Tensor   # (n_pivot, 2) rotated atom range
    restype: torch.Tensor       # (n_pivot,) proposal layer
    proposal_pot: torch.Tensor  # (n_layer, n_bin, n_bin) -log prob, float32
    proposal_cdf: torch.Tensor  # (n_layer, n_bin*n_bin) float32

    @classmethod
    def from_tables(cls, rama_atom, pivot_range, restype, proposal_pot,
                    device="cuda"):
        """Normalise the proposal table like the reference constructor
        (monte_carlo_sampler.cpp:61-77); the tables live on `device`."""
        pot = np.asarray(proposal_pot, np.float64)
        n_layer, n_bin, _ = pot.shape
        flat = pot.reshape(n_layer, -1)
        prob = np.exp(-flat)
        cdf = np.cumsum(prob, axis=1)
        total = cdf[:, -1:]
        cdf = cdf / total
        cdf[:, -1] = 1.0
        flat = flat + np.log(total)

        def dev(a, dt):
            return torch.as_tensor(np.asarray(a, dt), device=device)
        return cls(dev(rama_atom, np.int64), dev(pivot_range, np.int64),
                   dev(restype, np.int64),
                   dev(flat.reshape(n_layer, n_bin, n_bin), np.float32),
                   dev(cdf, np.float32))

    def draw(self, B, generator, dtype, device):
        """(B, 4) uniforms: the bin offsets in phi and psi, the pivot and
        the bin."""
        return torch.rand((B, 4), generator=generator, dtype=dtype,
                          device=device)

    def propose(self, pos, u):
        """(new positions (B, n, 3), log proposal ratio (B,))."""
        B = pos.shape[0]
        n_pivot = self.rama_atom.shape[0]
        n_bin = self.proposal_pot.shape[1]
        loc = torch.clamp((n_pivot * u[:, 2]).long(), max=n_pivot - 1)
        atom = self.rama_atom[loc]                               # (B, 5)
        lo, hi = self.pivot_range[loc].unbind(-1)
        layer = self.restype[loc]
        cdf = self.proposal_cdf[layer].to(u.dtype)
        pivot_bin = torch.clamp(
            torch.searchsorted(cdf, u[:, 3:4].contiguous()).squeeze(-1),
            max=n_bin * n_bin - 1)
        pot = self.proposal_pot[layer].reshape(B, -1)
        new_lprob = pot.gather(1, pivot_bin[:, None]).squeeze(-1)
        # half-bin shift: the left-most bin centre at -pi
        # (monte_carlo_sampler.cpp:102-104)
        phi_bin = torch.div(pivot_bin, n_bin, rounding_mode="floor")
        psi_bin = pivot_bin % n_bin
        scale = 2.0 * math.pi / n_bin
        new_phi = scale * (phi_bin + u[:, 0] - 0.5) - math.pi
        new_psi = scale * (psi_bin + u[:, 1] - 0.5) - math.pi

        prevC, N, CA, C, nextN = (_rows(pos, atom[:, k]) for k in range(5))
        old_phi = dihedral(prevC, N, CA, C)
        old_psi = dihedral(N, CA, C, nextN)

        def old_bin(angle):
            b = ((angle + math.pi) * (0.5 / math.pi) * n_bin + 0.5).long()
            return torch.where(b >= n_bin, torch.zeros_like(b), b)

        old_lprob = self.proposal_pot[layer, old_bin(old_phi),
                                      old_bin(old_psi)]
        phi_U = axis_angle_to_rot(new_phi - old_phi, normalized(CA - N))
        psi_U = axis_angle_to_rot(new_psi - old_psi, normalized(C - CA))

        idx = torch.arange(pos.shape[1], device=pos.device)
        move = ((idx >= lo[:, None]) & (idx < hi[:, None])) \
            | (idx == atom[:, 3:4]) | (idx == atom[:, 4:5])
        after_psi = C[:, None] + rotate_vec(psi_U[:, None],
                                            pos - C[:, None])
        after_phi = CA[:, None] + rotate_vec(phi_U[:, None],
                                             after_psi - CA[:, None])
        new_pos = torch.where(move[..., None], after_phi, pos)
        return new_pos, (new_lprob - old_lprob).to(pos.dtype)


@dataclass
class JumpSampler:
    atom_range: torch.Tensor    # (n_chain, 2)
    sigma_trans: torch.Tensor   # (n_chain,)
    sigma_rot: torch.Tensor     # (n_chain,)

    @classmethod
    def from_tables(cls, atom_range, sigma_trans, sigma_rot,
                    device="cuda"):
        return cls(torch.as_tensor(np.asarray(atom_range, np.int64),
                                   device=device),
                   torch.as_tensor(np.asarray(sigma_trans, np.float32),
                                   device=device),
                   torch.as_tensor(np.asarray(sigma_rot, np.float32),
                                   device=device))

    def draw(self, B, generator, dtype, device):
        """(uniforms (B, 2): move type and chain, normals (B, 3): the
        translation, normals (B, 4): the rotation's angle and axis)."""
        def like(f, n):
            return f((B, n), generator=generator, dtype=dtype, device=device)
        return like(torch.rand, 2), like(torch.randn, 3), like(torch.randn, 4)

    def propose(self, pos, draws):
        u, n_trans, n_rot = draws
        n_chain = self.atom_range.shape[0]
        move_type = (2.0 * u[:, 0]).long()                 # 0 trans, 1 rot
        chain = torch.clamp((n_chain * u[:, 1]).long(), max=n_chain - 1)
        lo, hi = self.atom_range[chain].unbind(-1)
        idx = torch.arange(pos.shape[1], device=pos.device)
        in_chain = ((idx >= lo[:, None]) & (idx < hi[:, None]))[..., None]
        nsel = in_chain.sum(1).to(pos.dtype)               # (B, 1)
        st = self.sigma_trans.to(pos.dtype)[chain]
        sr = self.sigma_rot.to(pos.dtype)[chain]

        disp = (st / math.sqrt(3.0))[:, None] * n_trans
        trans_pos = torch.where(in_chain, pos + disp[:, None], pos)

        axis = n_rot[:, 1:4] / (n_rot[:, 1:4].pow(2).sum(-1, keepdim=True)
                                .sqrt() + 1e-16)
        U = axis_angle_to_rot(sr * n_rot[:, 0], axis)
        com = torch.where(in_chain, pos, torch.zeros_like(pos)).sum(1) / nsel
        rot_pos = torch.where(
            in_chain, com[:, None] + rotate_vec(U[:, None],
                                                pos - com[:, None]), pos)
        new_pos = torch.where((move_type == 0)[:, None, None], trans_pos,
                              rot_pos)
        return new_pos, pos.new_zeros(pos.shape[0])


def metropolis_step(pos, temperature, energy_fn, sampler, generator=None,
                    draws=None):
    """One propose/accept cycle per replica (monte_carlo_sampler.cpp:
    255-284).  draws: (the sampler's proposal draws, acceptance uniforms
    (B,)), or None to take them from `generator`.  Returns (positions,
    accepted (B,) bool); a rejected replica keeps its positions exactly."""
    if draws is None:
        B = pos.shape[0]
        draws = (sampler.draw(B, generator, pos.dtype, pos.device),
                 torch.rand(B, generator=generator, dtype=pos.dtype,
                            device=pos.device))
    prop, u = draws
    e_old = energy_fn(pos)
    new_pos, delta_lprob = sampler.propose(pos, prop)
    e_new = energy_fn(new_pos)
    lboltz = delta_lprob - (e_new - e_old) / temperature
    accept = (lboltz >= 0.0) | (torch.exp(torch.clamp(lboltz, max=0.0)) >= u)
    return torch.where(accept[:, None, None], new_pos, pos), accept
