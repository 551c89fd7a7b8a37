"""Replica ensembles and training sharded over ranks (port of
upside_md_tpu/parallel/mesh.py).

The JAX package drives a device mesh from one controller: `shard_map`
gives each device its block of the `replica` axis, and the MD advance is
one share-nothing program a device.  Here each rank is a process of its
own under `torch.distributed`, with its own host thread to launch its
card's kernels (one thread driving several cards would serialise their
launches, and every path is host-bound at 64 replicas).  The names are
the JAX module's:

* `make_replica_mesh` wraps the process group: its rank, its size, its
  device (`cuda:<local rank>` unless the caller asks for the CPU) and the
  backend (NCCL for one card a rank, Gloo on the CPU; ranks that share one
  card pass Gloo, since NCCL refuses two ranks on one GPU).
* `shard_replica_state` keeps the rank's contiguous block of the replica
  axis, rows [r B / W, (r + 1) B / W), as `P("replica")` blocks it;
  `gather_replica_state` is its inverse.
* `sharded_advance` / `sharded_hamiltonian_advance` run
  `Simulation.advance` on the rank's rows with no collective between
  exchange rounds.  Every rank's generator is seeded alike and draws the
  whole ensemble's thermostat noise and Monte Carlo draws, through
  `advance`'s `noise=` and `mc_draws=` hooks, and keeps its rows: the
  sharded run takes the draws of the unsharded one.
* `sharded_attempt_swaps`: replica exchange across ranks; energies,
  positions and the warm-start cache are gathered at exchange rounds only,
  every rank takes the same accept decisions from the same uniforms and
  keeps its rows.
* `training_step` / `sharded_training_step`: the loss mean((E - target)^2)
  over the rank's positions, its gradients and the loss averaged over
  ranks (the `pmean`).

Every collective goes through a `ReplicaMesh` method and is counted in
`COLLECTIVES` (as `ops.kernels.LAUNCHES` counts launches): the port's
counterpart of the JAX dry run's zero-collective audit of the compiled
advance.  Host staging is a fixed rule of the mesh, not a fallback: under
Gloo a CUDA tensor is copied to the host for the collective and back
(`ReplicaMesh.staged`); NCCL takes the card's tensors.
"""

from __future__ import annotations

import os
from dataclasses import fields, replace

import torch
import torch.distributed as dist

from ..md.sim import SimState

COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "barrier": 0}


def reset_counts():
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def tree_map(fn, tree):
    """fn applied to every tensor of a nested dict (or a lone tensor)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class ReplicaMesh:
    """One rank of the replica axis: `rank` of `size`, its `device`, the
    process group's `backend`.  Its methods are the only collectives the
    port issues, each counted in COLLECTIVES."""

    axis = "replica"

    def __init__(self, rank, size, device, backend):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        # Gloo's collectives here run on host memory: its CUDA tensors go
        # through the host, by this rule and no other
        self.staged = backend == "gloo" and self.device.type == "cuda"

    def rows(self, n):
        """This rank's block of an axis of n replicas."""
        if n % self.size:
            raise ValueError(f"{n} replicas do not divide over "
                             f"{self.size} ranks of the '{self.axis}' axis")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_gather(self, t):
        """Every rank's t concatenated along the leading axis, in rank
        order."""
        COLLECTIVES["all_gather"] += 1
        x = (t.cpu() if self.staged else t).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        out = torch.cat(parts)
        return out.to(t.device) if self.staged else out

    def all_reduce_mean(self, t):
        """The mean of t over ranks (a new tensor)."""
        COLLECTIVES["all_reduce"] += 1
        x = t.detach().cpu() if self.staged else t.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return (x / self.size).to(t.device)

    def barrier(self):
        COLLECTIVES["barrier"] += 1
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self):
        """End the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_replica_mesh(world_size=None, rank=None, device=None, backend=None,
                      init_method=None):
    """The mesh of this process's rank.  Joins the process group (torchrun's
    environment: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT; or the
    arguments, as `init_method="tcp://localhost:<port>"` or
    `"file://<path>"`) unless it is already initialised.  device: cuda:<local
    rank> by default, "cpu" only when asked; the backend follows from it
    (NCCL on a card, Gloo on the CPU) unless given.  On a card, rank 0
    builds the kernels' library while the others wait at a barrier, then
    they load it."""
    if dist.is_initialized():
        world_size, rank = dist.get_world_size(), dist.get_rank()
    else:
        world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                         else world_size)
        rank = int(os.environ["RANK"] if rank is None else rank)
    if device is None or str(device) == "cuda":
        device = f"cuda:{os.environ.get('LOCAL_RANK', rank)}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_replica_mesh: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU")
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    mesh = ReplicaMesh(rank, world_size, device, dist.get_backend())
    if device.type == "cuda":
        from ..ops import kernels
        if rank == 0:
            kernels.library()
        mesh.barrier()
        if rank != 0:
            kernels.library()
    return mesh


# ---------------------------------------------------------------------------
# replica state
# ---------------------------------------------------------------------------

def _state_map(fn, state):
    """fn over every (B, ...) tensor of a SimState, the cache tree
    included; the round counter and n_evals as they are."""
    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        if isinstance(v, (torch.Tensor, dict)):
            v = tree_map(fn, v)
        out[f.name] = v
    return replace(state, **out)


def shard_replica_state(state: SimState, mesh) -> SimState:
    """This rank's rows of a replica-batched SimState (every (B, ...)
    tensor, the BP cache included).  B must divide by the mesh size."""
    B = state.pos.shape[0]
    rows = mesh.rows(B)

    def take(x):
        if x.shape[0] != B:
            raise ValueError(f"state tensor of shape {tuple(x.shape)} has "
                             f"no leading replica axis of {B}")
        return x[rows].clone()
    return _state_map(take, state)


def gather_replica_state(state: SimState, mesh) -> SimState:
    """The whole ensemble's SimState from every rank's rows (all_gather);
    the inverse of `shard_replica_state`."""
    return _state_map(mesh.all_gather, state)


# ---------------------------------------------------------------------------
# sharded advances
# ---------------------------------------------------------------------------

def whole_ensemble_draws(sim, mesh, state, noise=None):
    """`Simulation.advance`'s noise= and mc_draws= hooks for this rank's
    rows: the whole ensemble's draws, from `sim.generator` exactly as the
    unsharded advance draws them (the thermostat's from `noise`, a
    callable round -> the whole ensemble's noise, if given), of which the
    rank keeps its rows."""
    n_local = state.pos.shape[0]
    B = n_local * mesh.size
    rows = mesh.rows(B)
    pos = state.pos
    like = dict(dtype=pos.dtype, device=pos.device)

    def thermostat_noise(nr):
        full = noise(nr) if noise is not None else torch.randn(
            (B,) + tuple(pos.shape[1:]), generator=sim.generator, **like)
        return full[rows]

    def move_draws(nr, kind):
        sampler = getattr(sim, kind + "_sampler")
        prop = sampler.draw(B, sim.generator, pos.dtype, pos.device)
        u = torch.rand(B, generator=sim.generator, **like)
        if isinstance(prop, tuple):
            return tuple(p[rows] for p in prop), u[rows]
        return prop[rows], u[rows]
    return dict(noise=thermostat_noise, mc_draws=move_draws)


def sharded_advance(sim, mesh, n_rounds):
    """`sim.advance` of n_rounds on this rank's replicas.

    Returns advance(state, params=None, noise=None) -> state, for a state
    of this rank's rows (`shard_replica_state`).  The parameters are the
    whole set on every rank; noise, if given, returns the whole ensemble's
    thermostat noise of a round (as `Simulation.advance`'s hook does for
    its batch).  Nothing in it is a collective: between exchange rounds
    the ranks share nothing, the premise of running one rank a card."""
    def advance(state, params=None, noise=None):
        return sim.advance(state, n_rounds, params, None,
                           **whole_ensemble_draws(sim, mesh, state, noise))
    return advance


def shard_params(params, spec, mesh):
    """This rank's slots of a `stack_param_ensembles` set: the stacked
    leaves in `spec` cut to its rows, the shared ones whole (one table
    copy a rank)."""
    def cut(n, k, v):
        return v[mesh.rows(v.shape[0])] if (n, k) in spec else v
    return {n: {k: cut(n, k, v) for k, v in leaves.items()}
            for n, leaves in params.items()}


def sharded_hamiltonian_advance(sim, mesh, n_rounds, params, spec):
    """`sharded_advance` for a Hamiltonian ensemble (BASELINE config 4):
    the leaves named in `spec` carry a per-slot leading axis and are cut
    to the rank's slots beside its state; shared leaves stay whole.
    Returns (advance(state, noise=None) -> state, the rank's params)."""
    local = shard_params(params, spec, mesh)

    def advance(state, noise=None):
        return sim.advance(state, n_rounds, local, spec,
                           **whole_ensemble_draws(sim, mesh, state, noise))
    return advance, local


# ---------------------------------------------------------------------------
# replica exchange across ranks
# ---------------------------------------------------------------------------

def sharded_attempt_swaps(mesh, rex, state, replica_index, beta, energy_of,
                          stats=None, slot_independent=False,
                          generator=None):
    """One exchange round of `rex` (a `ReplicaExchange` over the whole
    ensemble) on sharded state.

    energy_of: this rank's positions -> their energies under its slots'
    parameters.  The rank evaluates its rows; the energies, positions and
    the warm-start cache are gathered; in a Hamiltonian ensemble each
    swap set's configurations are evaluated by the rank of the slot they
    move into, and those energies gathered.  Every rank then takes the
    same decisions (`rex.attempt_swaps` on the whole ensemble, from the
    shared-seed `generator`) and keeps its rows; the cache travels with
    the configurations.  replica_index, beta and stats are the whole
    ensemble's, on every rank.

    Returns (state of this rank's rows, replica_index, stats, energies)."""
    B = state.pos.shape[0] * mesh.size
    rows = mesh.rows(B)
    energies = mesh.all_gather(energy_of(state.pos))
    pos = mesh.all_gather(state.pos)
    cache = tree_map(mesh.all_gather, state.cache)

    def energy_of_all(swapped):
        return mesh.all_gather(energy_of(swapped[rows]))

    pos, replica_index, stats, energies, cache = rex.attempt_swaps(
        pos, replica_index, beta, energy_of_all, stats, energies,
        slot_independent, aux=cache, generator=generator)
    state = replace(state, pos=pos[rows].clone(),
                    cache=tree_map(lambda x: x[rows].clone(), cache))
    return state, replica_index, stats, energies


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

def training_step(system, optimizer_update, mesh):
    """One data-parallel energy-loss training step (mesh.py:107-134 of the
    JAX package; the reference's MPI gradient sum).

    Returns step(params, opt_state, pos_shard, target_shard) -> (params,
    opt_state, loss): the loss mean((E - target)^2) over this rank's
    positions (B_local, n_atom, 3); its gradient with respect to every
    floating-point leaf of params, and the loss, averaged over ranks (one
    all_reduce a dtype); then optimizer_update(params, grads, opt_state),
    grads holding those leaves as params holds them."""
    def step(params, opt_state, pos_shard, target_shard):
        leaves = {(n, k): v.detach().requires_grad_(True)
                  for n, group in params.items() for k, v in group.items()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()}
        p = {n: {k: leaves.get((n, k), v) for k, v in group.items()}
             for n, group in params.items()}
        with torch.enable_grad():
            e = system.energy(pos_shard, p)
            loss = ((e - target_shard) ** 2).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(leaves.values(), grads)]
        flat = [loss.detach().reshape(1)] + [g.reshape(-1) for g in grads]
        # the pmean: the loss and the gradients packed by dtype, one
        # all_reduce each
        for dtype in {t.dtype for t in flat}:
            idx = [i for i, t in enumerate(flat) if t.dtype == dtype]
            mean = mesh.all_reduce_mean(torch.cat([flat[i] for i in idx]))
            for i, part in zip(idx, mean.split([flat[i].numel()
                                                for i in idx])):
                flat[i] = part
        loss = flat[0].reshape(())
        tree = {}
        for (n, k), v, g in zip(leaves, leaves.values(), flat[1:]):
            tree.setdefault(n, {})[k] = g.reshape(v.shape)
        new_params, new_opt_state = optimizer_update(params, tree, opt_state)
        return new_params, new_opt_state, loss
    return step


def sharded_training_step(system, optimizer_update, mesh):
    """`training_step` bound to the mesh: step(params, opt_state,
    pos_batch, target) with the whole batch (B, n_atom, 3) and targets
    (B,) on every rank, of which each rank takes its rows (as shard_map's
    P("replica") in_specs split them)."""
    step = training_step(system, optimizer_update, mesh)

    def sharded(params, opt_state, pos_batch, target):
        rows = mesh.rows(pos_batch.shape[0])
        return step(params, opt_state, pos_batch[rows], target[rows])
    return sharded
