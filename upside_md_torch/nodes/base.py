"""Node registry, specs and topological order (port of
upside_md_tpu/nodes/base.py).

A node type is a function ``compute(consts, params, inputs, ctx)``:

* ``consts``: static data as tensors on the system's device (indices,
  masks) plus Python scalars, built once by the type's ``prepare``;
* ``params``: the node's parameter tensors;
* ``inputs``: outputs of the argument nodes, each (n_replica, n_elem,
  width); the replica axis always leads;
* ``ctx``: the evaluation context (`system.EvalContext`): warm-start cache,
  fused-block results, the node's own name and which of its parameters
  are stacked over replicas (``ctx.stacked``: such a leaf carries a
  leading replica axis, and the node evaluates each replica under its own
  value; `rows` and `type_pairs` take that axis into account).

Coordinate nodes return (n_replica, n_elem, width); potential nodes return
one energy per replica, (n_replica,).  Node types are looked up by exact
name: the bundle stores the JAX package's resolved type name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

NODE_REGISTRY: Dict[str, "NodeType"] = {}


@dataclass
class NodeType:
    name: str
    is_potential: bool
    compute: Callable          # (consts, params, inputs, ctx) -> tensor
    # (consts as numpy, device) -> consts as tensors; default: every
    # array becomes a tensor (floats in the system dtype, ints as int64)
    prepare: Optional[Callable] = None
    # (consts, n_replica, dtype) -> initial per-node solver state, or None
    init_cache: Optional[Callable] = None
    # the reference's flat-parameter API (engine.Upside): (consts, params)
    # -> flat numpy array, and (consts, params, flat numpy) -> new params
    get_param: Optional[Callable] = None
    set_param: Optional[Callable] = None


def register_node(name, is_potential, compute, prepare=None,
                  init_cache=None, get_param=None, set_param=None):
    if name in NODE_REGISTRY:
        raise ValueError(f"node type {name} registered twice")
    nt = NodeType(name, is_potential, compute, prepare, init_cache,
                  get_param, set_param)
    NODE_REGISTRY[name] = nt
    return nt


def resolve_node_type(name: str) -> NodeType:
    if name not in NODE_REGISTRY:
        raise KeyError(f"node type '{name}' has no port yet")
    return NODE_REGISTRY[name]


def to_tensor(v, device, dtype):
    """numpy -> a new tensor on device: floats in `dtype`, integers as
    int64 (torch's index type), bools as bool; Python scalars pass through.
    The tensor never shares memory with `v`, so an in-place update of a
    System's parameters (an optimizer step) leaves the caller's specs as
    they were."""
    if isinstance(v, (bool, int, float, str)):
        return v
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.tensor(a.astype(np.int64), device=device)
    if a.dtype.kind == "b":
        return torch.tensor(a, device=device)
    raise TypeError(f"cannot move array of dtype {a.dtype} to torch")


def rows(table, index, stacked):
    """table[index] along its first axis, or along its second when the
    table is `stacked` over replicas: (B, len(index), ...)."""
    return table[:, index] if stacked else table[index]


def per_slot(fn, table, *batched):
    """fn(table[i], *(x[i:i+1] for x in batched)) for each replica slot i
    of a `table` stacked over replicas, joined along the replica axis (each
    part joined where fn returns a tuple): a kernel reads one table a
    launch, so a stacked one launches once a slot."""
    outs = [fn(table[i], *(x[i:i + 1] for x in batched))
            for i in range(table.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(part) for part in zip(*outs))
    return torch.cat(outs)


def type_pairs(table, t1, t2, stacked):
    """The (n1, n2, ...) pair table of row types t1 and column types t2,
    with a leading replica axis when `table` is `stacked`."""
    if stacked:
        return table[:, t1[:, None], t2[None, :]]
    return table[t1[:, None], t2[None, :]]


@dataclass
class NodeSpec:
    """One node of the graph: numpy consts/params as the bundle holds them."""
    name: str
    node_type: NodeType
    args: List[str]
    consts: Dict[str, Any] = field(default_factory=dict)
    params: Dict[str, Any] = field(default_factory=dict)


def flat_param(key, dtype=None):
    """get_param/set_param of a node whose flat parameters are the one
    tensor `key` (the hooks of upside_md_tpu/nodes: rotamer.py:516-525,
    placement.py:80-87, env.py:137-143); get_param returns them in
    `dtype` where the JAX hook casts."""
    def get(c, p):
        flat = p[key].detach().cpu().numpy().ravel()
        return flat if dtype is None else flat.astype(dtype)

    def set_(c, p, flat):
        t = p[key]
        return {**p, key: torch.as_tensor(
            np.asarray(flat, np.float32).reshape(tuple(t.shape)),
            dtype=t.dtype, device=t.device)}
    return get, set_


def topo_sort(specs: Dict[str, NodeSpec]) -> List[NodeSpec]:
    """Kahn-style topological order over the argument DAG, ready nodes in
    name order (reference src/deriv_engine.cpp:213-229)."""
    order: List[NodeSpec] = []
    placed = {"pos"}
    remaining = dict(specs)
    remaining.pop("pos", None)
    while remaining:
        ready = [n for n, s in remaining.items()
                 if all(a in placed for a in s.args)]
        if not ready:
            raise ValueError(f"unsatisfiable dependencies among {list(remaining)}")
        for n in sorted(ready):
            order.append(remaining.pop(n))
            placed.add(n)
    return order
