"""Force-field parameter training (port of upside_md_tpu/training.py).

The JAX package replaces the reference's training stack (TensorFlow
py_func ops, Theano ops with a hand-written Adam, the MPI collective) with
jax.grad through the jitted energy plus optax.  Here the gradient is
autograd through the port's System: the fused pair block's table
cotangents (ops/fused_pair.py) and the rotamer node's envelope gradient
carry it to the tables, and `torch.optim.Adam` takes optax.adam's place
with the same update and defaults (betas 0.9 and 0.999, eps 1e-8, no
weight decay).

Parameters are the port's `{node: {name: tensor}}`; positions are
(n_atom, 3) for one configuration or (B, n_atom, 3) for a batch, where the
replica axis replaces the JAX package's `vmap`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .nodes.base import NodeSpec
from .ops.pairs import quadspline_family


def select_trainable(params: Dict, names: Iterable[str]):
    """Split the parameters into (trainable, frozen) by node name."""
    names = set(names)
    trainable = {k: v for k, v in params.items() if k in names}
    frozen = {k: v for k, v in params.items() if k not in names}
    return trainable, frozen


def merge_params(trainable: Dict, frozen: Dict):
    out = dict(frozen)
    out.update(trainable)
    return out


def energy_match_loss(system, pos_batch, target_energies):
    """Mean squared error of total energies over a batch of configurations
    (B, n_atom, 3) (the reference's UpsideTrajEnergy per-frame energies,
    rotamer_parameter_estimation.py:358-419)."""
    def loss(trainable, frozen):
        e = system.energy(pos_batch, merge_params(trainable, frozen))
        return ((e - target_energies) ** 2).mean()
    return loss


def energy_gap_loss(fixed_system, free_system, pos):
    """Native-rotamer log-likelihood: E_fixed - E_free is the free-energy
    cost of pinning side chains to their native rotamers; minimising it
    maximises the native rotamers' probability (the reference's
    UpsideEnergyGap, rotamer_parameter_estimation.py:213-263).  For a batch
    of configurations (B, n_atom, 3) the loss is the mean gap."""
    def loss(trainable, frozen):
        params = merge_params(trainable, frozen)
        gap = fixed_system.energy(pos, params) \
            - free_system.energy(pos, params)
        return gap.mean()
    return loss


def contrastive_divergence_loss(system, native_pos, ensemble_pos,
                                temperature=1.0):
    """Weighted-ensemble contrastive divergence (the reference's
    UpsideEnsemble op, tensorflow_upside.py:38-145): push the native energy
    down relative to the Boltzmann-weighted ensemble (B, n_atom, 3)."""
    def loss(trainable, frozen):
        params = merge_params(trainable, frozen)
        e_native = system.energy(native_pos, params)
        e_ens = system.energy(ensemble_pos, params)
        f_ens = -temperature * torch.logsumexp(-e_ens / temperature, 0) \
            + temperature * math.log(e_ens.shape[0])
        return e_native - f_ens
    return loss


def rotamer_state_restricted_system(system, states, node_name="rotamer"):
    """A new System with the rotamer node's valid-slot mask pinned to one
    rotamer state per residue: the 'fixed' engine of the reference's
    energy-gap training (rotamer_parameter_estimation.py:213-263).  The
    Bethe free energy of the restricted problem is the plain energy of that
    assignment, so F_fixed - F_free is the pinning cost.  It shares the
    caller's parameter tensors."""
    from .system import System

    states = np.asarray(states)
    out = []
    for s in system.specs:
        if s.name == node_name:
            n_rot = np.asarray(s.consts["n_rot_per_res"])
            if not (states < n_rot).all():
                raise ValueError("state index exceeds residue rotamer count")
            valid = np.zeros_like(np.asarray(s.consts["valid"]))
            valid[np.arange(len(states)), states] = True
            s = NodeSpec(s.name, s.node_type, s.args,
                         {**s.consts, "valid": valid}, s.params)
        out.append(s)
    fixed = System(system.n_atom, out, system.device, system.dtype,
                   not system.plain, system.residuals)
    fixed.params = system.params
    return fixed


def rotamer_node_marginals(system, pos, params=None, node_name="rotamer"):
    """Converged BP node marginals (n_res, 6) of the rotamer node at one
    configuration (n_atom, 3), or (B, n_res, 6) for a batch: the
    l1-normalised beliefs the node leaves in its cache after a cold-start
    solve (those of `rotamer_marginals`, upside_md_tpu/nodes/rotamer.py
    :618).  The argmax over slots is the predicted rotamer state."""
    one = pos.ndim == 2
    with torch.no_grad():
        ctx = system.evaluate(pos[None] if one else pos, params=params)[3]
    nb = ctx.cache_out[node_name]["nb"]
    return nb[0] if one else nb


class QuadsplinePacking:
    """Constrained parameterization of a directional-spline table
    (n1, n2, 2*ka + 2*k): the optimizer works in an unconstrained vector
    and `unpack` maps it onto a table that is always physically valid
    (reference rotamer_parameter_estimation.py:41-150).

    Constraints, matching the reference's transforms:
      * angular segments: sigmoid-bounded to (0, 1),
      * distance segments: clamped cubic splines, zero slope at the left
        boundary (c0 = c1) and zero value and slope at the right one
        (c[-2] = -0.5 c[-3], c[-1] = c[-3]),
      * optionally symmetric in the two type axes (bead-bead tables).

    `pack` is the exact inverse on constraint-satisfying tables and a
    projection otherwise (middle knots exact, boundary rows re-derived).
    """

    def __init__(self, n1, n2, ka, k, symmetric=False):
        self.n1, self.n2, self.ka, self.k = n1, n2, ka, k
        self.symmetric = symmetric
        n_ang = ka if symmetric else 2 * ka
        self.width = n_ang + 2 * (k - 3)
        self.n_free = n1 * n2 * self.width

    @staticmethod
    def _clamp(mid):
        c0 = mid[..., 1:2]
        cn3 = mid[..., -1:]
        return torch.cat([c0, mid, -0.5 * cn3, cn3], dim=-1)

    def unpack(self, theta):
        n1, n2, ka, k = self.n1, self.n2, self.ka, self.k
        theta = theta.reshape(n1, n2, self.width)
        if self.symmetric:
            ang1 = torch.sigmoid(theta[..., :ka])
            ang2 = ang1.transpose(0, 1)
            off = ka

            def sym(x):
                return 0.5 * (x + x.transpose(0, 1))

            wide = self._clamp(sym(theta[..., off:off + k - 3]))
            narrow = self._clamp(sym(theta[..., off + k - 3:]))
        else:
            ang1 = torch.sigmoid(theta[..., :ka])
            ang2 = torch.sigmoid(theta[..., ka:2 * ka])
            off = 2 * ka
            wide = self._clamp(theta[..., off:off + k - 3])
            narrow = self._clamp(theta[..., off + k - 3:])
        return torch.cat([ang1, ang2, wide, narrow], dim=-1)

    def pack(self, table):
        """Exact inverse of unpack for tables satisfying the constraints; a
        projection otherwise.  Returns a flat float64 numpy vector."""
        ka, k = self.ka, self.k
        if isinstance(table, torch.Tensor):
            table = table.detach().cpu().numpy()
        table = np.asarray(table, np.float64)
        eps = 1e-7

        def logit(p):
            p = np.clip(p, eps, 1 - eps)
            return np.log(p / (1 - p))

        off = 2 * ka
        wide_mid = table[..., off + 1:off + k - 2]
        narrow_mid = table[..., off + k + 1:off + 2 * k - 2]
        if self.symmetric:
            parts = [logit(table[..., :ka]),
                     0.5 * (wide_mid + np.swapaxes(wide_mid, 0, 1)),
                     0.5 * (narrow_mid + np.swapaxes(narrow_mid, 0, 1))]
        else:
            parts = [logit(table[..., :ka]), logit(table[..., ka:2 * ka]),
                     wide_mid, narrow_mid]
        return np.concatenate(parts, axis=-1).reshape(-1)


def rotamer_packings(params, rotamer_node="rotamer"):
    """Packings for the rotamer pair table and the hbond coverage /
    hydrophobe tables, inferred from the stored shapes."""
    packs = {}
    for name, p in params.items():
        t = p.get("interaction_param")
        if t is None or t.ndim != 3:
            continue
        try:
            ka, k, _ = quadspline_family(t.shape[-1])
        except ValueError:
            continue
        packs[name] = QuadsplinePacking(
            t.shape[0], t.shape[1], ka, k,
            symmetric=(name.startswith(rotamer_node)
                       and t.shape[0] == t.shape[1]))
    return packs


def _adam(leaves, learning_rate):
    """The optimizer of `fit` / `fit_packed`: optax.adam's update and
    defaults."""
    return torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def _finite(loss, step):
    value = float(loss.detach())
    if not np.isfinite(value):
        # the reference's training aborts on NaN energies
        # (rotamer_parameter_estimation.py:198-201, 255-260)
        raise FloatingPointError(
            f"non-finite training loss at step {step}: {value}")
    return value


def fit_packed(system, loss_of_params, params, pack_names, n_steps=50,
               learning_rate=1e-3):
    """Constrained training: optimise the packed (unconstrained) vectors of
    the named interaction tables with Adam; every step's tables are valid
    by construction.  `loss_of_params(params)` returns a scalar tensor.
    Each step unpacks new table tensors, so the fused block rebuilds its
    coefficients once per step (a host round trip of the table).  Returns
    (fitted params, loss history)."""
    packs = {k: v for k, v in rotamer_packings(params).items()
             if k in set(pack_names)}
    theta = {k: torch.tensor(packs[k].pack(params[k]["interaction_param"]),
                             dtype=params[k]["interaction_param"].dtype,
                             device=params[k]["interaction_param"].device,
                             requires_grad=True) for k in packs}
    opt = _adam(list(theta.values()), learning_rate)

    def unpacked():
        p = {k: dict(v) for k, v in params.items()}
        for k, pk in packs.items():
            p[k]["interaction_param"] = pk.unpack(theta[k])
        return p

    history = []
    for i in range(n_steps):
        opt.zero_grad()
        loss = loss_of_params(unpacked())
        history.append(_finite(loss, i))
        loss.backward()
        opt.step()
    with torch.no_grad():
        out = unpacked()
    return out, history


def fit(loss_fn, trainable, frozen, n_steps=100, learning_rate=1e-3,
        callback: Optional[Callable] = None):
    """Optimise the trainable parameters (default Adam; the reference
    implements Adam by hand, rotamer_parameter_estimation.py:266-310).
    `loss_fn(trainable, frozen)` returns a scalar tensor.  Returns (the
    trained parameters, loss history)."""
    trainable = {n: {k: v.detach().clone().requires_grad_(True)
                     for k, v in p.items()} for n, p in trainable.items()}
    leaves = [v for p in trainable.values() for v in p.values()]
    opt = _adam(leaves, learning_rate)
    history = []
    for i in range(n_steps):
        opt.zero_grad()
        loss = loss_fn(trainable, frozen)
        history.append(_finite(loss, i))
        loss.backward()
        opt.step()
        if callback is not None:
            callback(i, trainable, history[-1])
    return {n: {k: v.detach() for k, v in p.items()}
            for n, p in trainable.items()}, history


def multi_system_gradient(systems_and_pos, params):
    """Summed energy and parameter gradient over independent systems that
    share one parameter set: the reference's MPI data parallelism
    (tensorflow_upside.py:61-73, comm.Reduce of gradients).  Returns
    (summed energy, {node: {name: gradient}} of every floating tensor)."""
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in p.items()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()}
              for n, p in params.items()}
    merged = {n: {**params[n], **leaves[n]} for n in params}
    flat = [v for p in leaves.values() for v in p.values()]
    total = 0.0
    grads = [torch.zeros_like(v) for v in flat]
    for system, pos in systems_and_pos:
        e = system.energy(torch.as_tensor(pos, dtype=system.dtype,
                                          device=system.device), merged)
        g = torch.autograd.grad(e.sum(), flat, allow_unused=True)
        grads = [a if b is None else a + b for a, b in zip(grads, g)]
        total = total + float(e.detach().sum())
    it = iter(grads)
    return total, {n: {k: next(it) for k in p} for n, p in leaves.items()}
