"""Replica exchange over a replica batch (port of upside_md_tpu/md/
replica.py; reference src/main.cpp:140-276).

The ensemble is one batched tensor, so a swap set is a gather.  Energies
are evaluated once per exchange round and carried through the swap sets:
with one Hamiltonian for every slot (pure temperature exchange) swapping
configurations only permutes them; in a Hamiltonian ensemble each set
evaluates its swapped configurations once, under each slot's own
parameters.  Accept decisions, statistics and `replica_index` stay on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


def parse_swap_sets(strings: List[str], n_replica: int):
    """Parse '0-1,2-3' style swap-set strings with the reference's
    non-overlap validation (main.cpp:153-192)."""
    swap_sets = []
    for s in strings:
        pairs = []
        seen = set()
        for pair_str in s.split(','):
            a, b = (int(x) for x in pair_str.split('-'))
            if a >= n_replica or b >= n_replica:
                raise ValueError(f"invalid system index in swap pair {a}-{b}")
            if a in seen or b in seen or a == b:
                raise ValueError(
                    "Overlapping indices in swap set; no replica index can "
                    "appear more than once in a swap set")
            seen.update((a, b))
            pairs.append((a, b))
        swap_sets.append(pairs)
    return swap_sets


def permute_tree(tree, index):
    """Every tensor of a nested dict with a leading replica axis, gathered
    along that axis by `index` (B,)."""
    if isinstance(tree, dict):
        return {k: permute_tree(v, index) for k, v in tree.items()}
    return tree.index_select(0, index)


@dataclass
class ReplicaExchange:
    swap_sets: List[List[Tuple[int, int]]]
    n_replica: int

    def permutations(self):
        perms = []
        for pairs in self.swap_sets:
            perm = np.arange(self.n_replica)
            for a, b in pairs:
                perm[a], perm[b] = perm[b], perm[a]
            perms.append(perm)
        return perms

    def attempt_swaps(self, pos, replica_index, beta, energy_of_pos,
                      stats=None, energies=None, slot_independent=False,
                      aux=None, generator=None, uniforms=None):
        """One exchange round over all swap sets (replica.py:59-135).

        energy_of_pos: (B, n_atom, 3) -> (B,) energies, each in its
        slot's Hamiltonian.  energies: optional (B,) energies of `pos`,
        which skips the first evaluation.  slot_independent: every slot
        shares one Hamiltonian, so swapped energies are a permutation and
        nothing is evaluated.  aux: a nested dict of tensors with a leading
        replica axis (the solver warm-start cache) that travels WITH the
        configurations.  uniforms: optional list of (n_pairs,) acceptance
        uniforms, one per set; otherwise drawn from `generator`.

        Returns (pos, replica_index, stats, energies, aux): stats
        accumulates (n_success, n_attempt) per pair per set, energies are
        the per-slot energies of the returned positions.  Temperatures,
        momenta and parameters stay with their slots."""
        dev = pos.device
        if stats is None:
            stats = [torch.zeros((len(p), 2), dtype=torch.int32, device=dev)
                     for p in self.swap_sets]
        if energies is None:
            energies = energy_of_pos(pos)
        arange = torch.arange(self.n_replica, device=dev)
        new_stats = []
        for si, (pairs, perm) in enumerate(
                zip(self.swap_sets, self.permutations())):
            perm = torch.as_tensor(perm, device=dev)
            swapped = pos.index_select(0, perm)
            new_energies = energies[perm] if slot_independent \
                else energy_of_pos(swapped)
            pa = torch.as_tensor([p[0] for p in pairs], device=dev)
            pb = torch.as_tensor([p[1] for p in pairs], device=dev)
            old_lboltz, new_lboltz = -beta * energies, -beta * new_energies
            ldiff = (new_lboltz[pa] + new_lboltz[pb]) \
                - (old_lboltz[pa] + old_lboltz[pb])
            u = uniforms[si] if uniforms is not None else torch.rand(
                len(pairs), generator=generator, dtype=pos.dtype, device=dev)
            accept = (ldiff >= 0.0) | \
                (torch.exp(torch.clamp(ldiff, max=0.0)) >= u)
            accept_rep = torch.zeros(self.n_replica, dtype=torch.bool,
                                     device=dev)
            accept_rep[pa] = accept
            accept_rep[pb] = accept
            sel = torch.where(accept_rep, perm, arange)
            pos = torch.where(accept_rep[:, None, None], swapped, pos)
            energies = torch.where(accept_rep, new_energies, energies)
            replica_index = replica_index.index_select(0, sel)
            if aux is not None:
                aux = permute_tree(aux, sel)
            new_stats.append(stats[si] + torch.stack(
                [accept.to(torch.int32), torch.ones_like(
                    accept, dtype=torch.int32)], -1))
        return pos, replica_index, new_stats, energies, aux


def even_odd_swap_sets(n_replica: int):
    """The standard neighbour-exchange schedule: (0-1, 2-3, ...) and
    (1-2, 3-4, ...), as the reference's run_upside.swap_table2d gives for
    ladder topologies."""
    s0 = [(i, i + 1) for i in range(0, n_replica - 1, 2)]
    s1 = [(i, i + 1) for i in range(1, n_replica - 1, 2)]
    return [s0, s1] if s1 else [s0]
