"""Plain contrastive-divergence training steps (the reference's
UpsideEnsemble op, tensorflow_upside.py:38-145, with Adam as
rotamer_parameter_estimation.py:266-310 writes it), for the benchmark's
reference.

loss = E(native) - F(ensemble),  F = -T log sum_k exp(-E_k / T) + T log n.

Its gradient is dE(native) - sum_k w_k dE_k with w = softmax(-E / T); the
ensemble is taken in blocks, so the reference fits beside nothing else.
Adam: m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, then
x <- x - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
"""

from __future__ import annotations

import math

import torch


def loss_and_grad(ff, tables, native, ens, temperature=1.0, block=16):
    """(loss, {node: gradient}) with `tables` {node: interaction_param}
    in place of the force field's own."""
    def params(leaves):
        p = {n: dict(v) for n, v in ff.params.items()}
        for n, t in leaves.items():
            p[n]["interaction_param"] = t
        return p

    with torch.no_grad():
        e = torch.cat([ff.energy(ens[i:i + block], params(tables))
                       for i in range(0, len(ens), block)])
    w = torch.softmax(-e / temperature, 0)
    f_ens = -temperature * torch.logsumexp(-e / temperature, 0) \
        + temperature * math.log(len(ens))
    grads = {n: torch.zeros_like(t) for n, t in tables.items()}
    parts = [(native[None], torch.ones(1, dtype=ff.dtype,
                                       device=native.device))] + [
        (ens[i:i + block], -w[i:i + block])
        for i in range(0, len(ens), block)]
    e_native = None
    for x, weight in parts:
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in tables.items()}
        with torch.enable_grad():
            en = ff.energy(x, params(leaves))
            gs = torch.autograd.grad((en * weight).sum(),
                                     list(leaves.values()))
        if e_native is None:
            e_native = en.detach()[0]
        for n, g in zip(leaves, gs):
            grads[n] += g
    return float(e_native - f_ens), grads


def follow(ff, names, native, ens, n_steps, lr, betas=(0.9, 0.999),
           eps=1e-8, temperature=1.0, block=16):
    """Adam steps on the named nodes' interaction tables from the force
    field's own.  Returns (losses, first gradient, change after n_steps),
    the last two {node: tensor}."""
    x = {n: ff.params[n]["interaction_param"].clone() for n in names}
    x0 = {n: t.clone() for n, t in x.items()}
    m = {n: torch.zeros_like(t) for n, t in x.items()}
    v = {n: torch.zeros_like(t) for n, t in x.items()}
    b1, b2 = betas
    losses, first = [], None
    for t in range(1, n_steps + 1):
        loss, g = loss_and_grad(ff, x, native, ens, temperature, block)
        losses.append(loss)
        first = first or g
        for n in names:
            m[n] = b1 * m[n] + (1 - b1) * g[n]
            v[n] = b2 * v[n] + (1 - b2) * g[n] * g[n]
            x[n] = x[n] - lr * (m[n] / (1 - b1 ** t)) / (
                torch.sqrt(v[n] / (1 - b2 ** t)) + eps)
    return losses, first, {n: x[n] - x0[n] for n in names}
