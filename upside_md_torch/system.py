"""System: the node graph producing one potential per replica (port of
upside_md_tpu/system.py; reference DerivEngine, src/deriv_engine.cpp).

Positions carry an explicit leading replica axis, (B, n_atom, 3); node
tables are shared across replicas, or, in a Hamiltonian ensemble
(md/sim.py `stack_param_ensembles`), a parameter leaf carries a leading
replica axis of its own and every slot is evaluated under its own value.
The plain nodes broadcast such a leaf; a stacked table of the fused pair
block runs the block once per replica slot, each with its own operands
(the `lax.map` fallback of the JAX kernels' vmap rules,
pallas_quadspline.py:671-676, :1841-1846).  Forces are
-d(sum of energies)/d(pos) from `torch.autograd.grad`.  The fused pair
block (nodes/fusion.py) fires at the first coverage member;
`System.__init__` moves that member directly before the second so every
fused input exists by then.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import nodes  # noqa: F401  (registers the node types)
from . import tracing
from .config import bundle
from .nodes.base import NodeSpec, resolve_node_type, to_tensor, topo_sort
from .nodes.fusion import plan_pair_fusion


class EvalContext:
    """Per-evaluation state the nodes read and write."""

    def __init__(self, cache=None, plain=False, n_replica=1,
                 n_deriv_evals=0):
        self.cache = cache or {}     # previous evaluation's solver state
        self.cache_out = {}          # this evaluation's solver state
        self.fused = {}              # fused pair block results by node
        self.node_name = None
        # names of the node's parameters stacked over replicas
        self.stacked = frozenset()
        self.plain = plain           # plain versions on the card
        self.n_replica = n_replica   # for nodes without inputs (constant)
        # force evaluations so far, a host int: AFM's tip moves with it
        # (the JAX package's extra["n_deriv_evals"]; 0 in an energy-only
        # evaluation, as there)
        self.n_deriv_evals = n_deriv_evals


def slot_params(params, spec, i):
    """Replica slot i's own parameters out of a stacked set: the leaves in
    `spec` ((node, name) pairs) indexed, the shared ones as they are."""
    return {n: {k: v[i] if (n, k) in spec else v for k, v in leaves.items()}
            for n, leaves in params.items()}


class System:
    def __init__(self, n_atom: int, specs: List, device="cuda",
                 dtype=torch.float32, kernels=True, residuals=True):
        """specs: bundle SpecRecords (or port NodeSpecs).  The system runs
        on the card unless `device` says otherwise (the CPU runs every
        kernel's plain version); without a CUDA device the default raises.
        kernels=False makes every kernel wrapper take its plain version even
        on the card; it exists to compare the two and nothing on the main
        path sets it.  residuals=False makes the fused block with its env
        band keep no residual planes between forward and backward (K3
        recomputes them, as the JAX package does under
        UPSIDE_FUSED_RESID=0); nothing on the main path sets it either."""
        self.n_atom = n_atom
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System: no CUDA device; pass device='cpu' "
                               "to run the plain versions on the CPU")
        self.dtype = dtype
        self.plain = not kernels
        self.residuals = residuals
        node_specs = [s if isinstance(s, NodeSpec) else NodeSpec(
            s.name, resolve_node_type(s.type_name), list(s.args),
            dict(s.consts), dict(s.params)) for s in specs]
        by_name = {s.name: s for s in node_specs}
        if len(by_name) != len(node_specs):
            raise ValueError("duplicate node names")
        self.specs = topo_sort(by_name)
        self.pair_fusion = plan_pair_fusion(self.specs)
        if self.pair_fusion is not None:
            order = [s.name for s in self.specs]
            i1 = order.index(self.pair_fusion.cov1.name)
            i2 = order.index(self.pair_fusion.cov2.name)
            if i2 - i1 > 1:
                moved = self.specs[i1]
                self.specs = (self.specs[:i1] + self.specs[i1 + 1:i2]
                              + [moved] + self.specs[i2:])
        self.by_name = {s.name: s for s in self.specs}
        self.consts = {}
        self.params = {}
        for s in self.specs:
            prep = s.node_type.prepare
            self.consts[s.name] = (
                prep(s.consts, self.device, dtype) if prep else
                {k: to_tensor(v, self.device, dtype)
                 for k, v in s.consts.items()})
            self.params[s.name] = {k: to_tensor(v, self.device, dtype)
                                   for k, v in s.params.items()}
        self._prep_memo = None

    @classmethod
    def from_records(cls, specs, pos, device="cuda", dtype=torch.float32,
                     kernels=True):
        """(System, initial positions (n_atom, 3) tensor) from SpecRecords
        and numpy positions."""
        system = cls(len(pos), specs, device, dtype, kernels)
        return system, torch.as_tensor(pos, dtype=dtype, device=device)

    @classmethod
    def from_bundle(cls, path, device="cuda", dtype=torch.float32,
                    kernels=True):
        """(System, initial positions (n_atom, 3) tensor) from a bundle."""
        return cls.from_records(*bundle.load(path), device, dtype, kernels)

    @classmethod
    def from_up(cls, path, device="cuda", dtype=torch.float32, kernels=True):
        """(System, initial positions (n_atom, 3) tensor) from a `.up`
        configuration, read without h5py (`config/reader.py`)."""
        from .config.reader import load_up
        return cls.from_records(*load_up(path)[:2], device, dtype, kernels)

    @classmethod
    def from_config(cls, path, device="cuda", dtype=torch.float32,
                    kernels=True):
        """`from_bundle` for a `.npz`, `from_up` for a `.up` or `.h5`."""
        from .config import load
        return cls.from_records(*load(path)[:2], device, dtype, kernels)

    # -- parameter-only operands ----------------------------------------------

    def stacked_leaves(self, params) -> frozenset:
        """The (node, name) leaves of `params` that carry a leading replica
        axis the system's own lack: `stack_param_ensembles`' spec."""
        if params is self.params:
            return frozenset()
        return frozenset(
            (n, k) for n, leaves in params.items() for k, v in leaves.items()
            if isinstance(v, torch.Tensor)
            and v.ndim > np.ndim(self.params[n][k]))

    def fused_prepared(self, params=None):
        """The fused block's parameter-only operands, rebuilt only when a
        table tensor it reads changes: the memo of sim.py:244-271, keyed on
        (id, version) of each table, so an in-place optimizer step
        invalidates it.  The memo holds the tensors, so no new tensor can
        take a key's id while it stands.  When a table is stacked over
        replicas, a list of every slot's operands."""
        if self.pair_fusion is None:
            return None
        params = self.params if params is None else params
        tabs = self.pair_fusion.tables(params)
        key = tuple((id(t), t._version) for t in tabs if t is not None)
        if self._prep_memo is None or self._prep_memo[0] != key:
            with tracing.span("fused_pair.prepare"):
                self._prep_memo = (key, tabs, self._fused_prepare(params))
        return self._prep_memo[2]

    def _fused_prepare(self, params):
        """`fused_prepared`'s operands, built anew."""
        fusion = self.pair_fusion
        spec = {(n, "interaction_param") for n in fusion.table_nodes} \
            & self.stacked_leaves(params)
        if not spec:
            return fusion.prepare(params, self.device, self.dtype)
        n_slot = params[next(iter(spec))[0]]["interaction_param"].shape[0]
        return [fusion.prepare(slot_params(params, spec, i), self.device,
                               self.dtype) for i in range(n_slot)]

    # -- graph evaluation ---------------------------------------------------

    def evaluate(self, pos, cache: Optional[Dict] = None, fused_prep=None,
                 params: Optional[Dict] = None,
                 inject: Optional[Dict] = None, n_deriv_evals: int = 0):
        """Run the graph on pos (B, n_atom, 3).  Returns (total (B,),
        outputs, per_term, ctx); ctx.cache_out holds the new solver state.
        params: {node: {name: tensor}} in place of `self.params` (its
        tensors may require grad; a leaf with a leading replica axis of
        size B gives each replica its own value); inject: {node: tensor}
        added to that node's output (how `get_sens` reads output
        cotangents); n_deriv_evals: the force-evaluation counter AFM reads
        (the MD loop passes 3 * round + stage + 1), and the id of the
        evaluation's spans: `node.<name>` around each node's compute and
        `node.<name>.bwd` around its backward, `fused_pair` and
        `fused_pair.bwd` around the fused block's (`tracing.py`)."""
        params = self.params if params is None else params
        spec = self.stacked_leaves(params)
        for n, k in spec:
            if params[n][k].shape[0] != pos.shape[0]:
                raise ValueError(f"parameter {n}/{k} is stacked over "
                                 f"{params[n][k].shape[0]} replicas, the "
                                 f"positions hold {pos.shape[0]}")
        ctx = EvalContext(cache, self.plain, pos.shape[0], n_deriv_evals)
        outputs = {"pos": pos}
        per_term = {}
        fusion = self.pair_fusion
        for s in self.specs:
            if fusion is not None and s.name == fusion.trigger_name:
                prep = fused_prep if fused_prep is not None \
                    else self.fused_prepared(params)
                ctx.fused = self._fused_block(outputs, prep, params,
                                              n_deriv_evals)
            ctx.node_name = s.name
            ctx.stacked = frozenset(k for n, k in spec if n == s.name)
            name = "node." + s.name
            bwd = tracing.backward_span(name + ".bwd", n_deriv_evals)
            with tracing.span(name, n_deriv_evals):
                out = s.node_type.compute(self.consts[s.name],
                                          params.get(s.name, {}),
                                          [outputs[a] for a in s.args], ctx)
                if bwd is not None:
                    out = bwd(out)
            if s.node_type.is_potential:
                per_term[s.name] = out
            else:
                if inject is not None and s.name in inject:
                    out = out + inject[s.name]
                outputs[s.name] = out
        total = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
        for v in per_term.values():
            total = total + v
        return total, outputs, per_term, ctx

    def _fused_block(self, outputs, prep, params, n_deriv_evals):
        """The fused block's member outputs, in its spans."""
        fusion = self.pair_fusion
        bwd = tracing.backward_span("fused_pair.bwd", n_deriv_evals)
        with tracing.span("fused_pair", n_deriv_evals):
            fused = fusion.compute(self.consts, outputs, prep, params,
                                   self.plain, self.residuals)
            if bwd is not None:
                fused = dict(zip(fused, bwd(tuple(fused.values()))))
        return fused

    def init_cache(self, n_replica: int) -> Dict:
        """Initial solver state (BP warm-start beliefs) for n_replica."""
        cache = {}
        for s in self.specs:
            if s.node_type.init_cache is not None:
                cache[s.name] = s.node_type.init_cache(
                    self.consts[s.name], n_replica, self.dtype)
        return cache

    def energy_and_cache(self, pos, cache=None, fused_prep=None,
                         params=None, n_deriv_evals=0):
        """(energy (B,), new cache): threads per-node solver state."""
        total, _, _, ctx = self.evaluate(pos, cache, fused_prep, params,
                                         n_deriv_evals=n_deriv_evals)
        new_cache = dict(cache or {})
        new_cache.update(ctx.cache_out)
        return total, new_cache

    def energy(self, pos, params=None, n_deriv_evals=0):
        """Total potential from a cold solver start: (B,) for pos (B,
        n_atom, 3), a scalar for one configuration (n_atom, 3), as the JAX
        System's `energy(pos, params)`.  Differentiable in `params`."""
        one = pos.ndim == 2
        total = self.evaluate(pos[None] if one else pos, params=params,
                              n_deriv_evals=n_deriv_evals)[0]
        return total[0] if one else total

    def deriv(self, pos, cache=None, fused_prep=None, params=None,
              n_deriv_evals=0):
        """(dU/dpos (B, n_atom, 3), energy (B,), new cache)."""
        with torch.enable_grad():
            x = pos.detach().requires_grad_(True)
            total, new_cache = self.energy_and_cache(x, cache, fused_prep,
                                                     params, n_deriv_evals)
            (g,) = torch.autograd.grad(total.sum(), x)
        return g, total.detach(), new_cache

    # -- outputs, sensitivities and parameter derivatives (system.py:133-152)

    def get_output(self, pos, name, params=None):
        """Output of node `name` (B, n_elem, width) at pos (B, n_atom, 3)."""
        with torch.no_grad():
            return self.evaluate(pos, params=params)[1][name]

    def get_sens(self, pos, name, params=None):
        """Cotangent of the summed total potential with respect to node
        `name`'s output (the reference's 'sens'): the gradient at a zero
        injection into that output."""
        z = torch.zeros_like(self.get_output(pos, name, params),
                             requires_grad=True)
        with torch.enable_grad():
            total = self.evaluate(pos.detach(), params=params,
                                  inject={name: z})[0]
            (g,) = torch.autograd.grad(total.sum(), z)
        return g

    def param_deriv(self, pos, name, params=None):
        """Gradient of the summed total potential with respect to node
        `name`'s parameter tensors: {param name: tensor}."""
        params = dict(self.params if params is None else params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params[name].items()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()}
        params[name] = {**params[name], **leaves}
        with torch.enable_grad():
            total = self.evaluate(pos.detach(), params=params)[0]
            grads = torch.autograd.grad(total.sum(), list(leaves.values()),
                                        allow_unused=True)
        return {k: torch.zeros_like(v) if g is None else g
                for (k, v), g in zip(leaves.items(), grads)}


def freeze_static_nodes(system, params=None):
    """Fold every node that does not depend on `pos` and is not a
    potential into a `constant` node holding its output (the JAX
    package's `freeze_static_nodes`, system.py:159-189; the reference's
    upside_engine.freeze_nodes).  Returns (frozen_system,
    frozen_params): the system on the same device, dtype and kernel
    settings, and `params` (the system's own by default) with each frozen
    node's parameters replaced by {"value": its output}."""
    params = system.params if params is None else params
    depends = {"pos"}
    for s in system.specs:
        if any(a in depends for a in s.args):
            depends.add(s.name)
    # the static nodes alone, in graph order (their inputs are static too)
    ctx = EvalContext()
    outputs = {}
    with torch.no_grad():
        for s in system.specs:
            if s.name not in depends and not s.node_type.is_potential:
                ctx.node_name = s.name
                outputs[s.name] = s.node_type.compute(
                    system.consts[s.name], params.get(s.name, {}),
                    [outputs[a] for a in s.args], ctx)
    specs, frozen_params = [], {}
    for s in system.specs:
        if s.name in depends or s.node_type.is_potential:
            specs.append(s)
            if s.name in params:
                frozen_params[s.name] = params[s.name]
        else:
            value = {"value": outputs[s.name][0]}
            specs.append(NodeSpec(s.name, resolve_node_type("constant"), [],
                                  {}, value))
            frozen_params[s.name] = value
    frozen = System(system.n_atom, specs, system.device, system.dtype,
                    kernels=not system.plain, residuals=system.residuals)
    return frozen, frozen_params
