"""The port's Monte Carlo samplers (upside_md_torch/md/mc.py) against the
JAX package's, batched over replicas, on the JAX package's own draws:

* `PivotSampler.from_tables`: normalised proposal table and CDF, rtol
  1e-6, from the trp-cage bundle's pivot rows (as `ConfigBuilder.finalize`
  makes them, config/builder.py:743-755) and a seeded proposal map;
* `propose` on `jax.random.uniform(key, (4,))` per replica: positions atol
  1e-5, the log proposal ratio rel 1e-6;
* both move types of `JumpSampler` on a two-chain system built with jump
  moves (`ConfigBuilder.add_chain_breaks`);
* `metropolis_step` accepting and rejecting on fixed uniforms, a rejected
  replica keeping its positions exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_nodes import TRP
from upside_md_tpu.config.builder import ConfigBuilder
from upside_md_tpu.md.mc import JumpSampler as JJump
from upside_md_tpu.md.mc import PivotSampler as JPivot
from upside_md_tpu.md.mc import metropolis_step as jmetropolis
from upside_md_torch.config import bundle
from upside_md_torch.md.mc import JumpSampler, PivotSampler, metropolis_step

N_KEY = 12


def pivot_tables(records, n_atom, seed=0, n_bin=72):
    """(rama_atom, pivot_range, restype, proposal_pot) as
    `ConfigBuilder.finalize` derives them from the Rama nodes
    (config/builder.py:743-755), with a seeded proposal map in place of
    the Rama map the bundles drop."""
    by = {r.name: r for r in records}
    rc = np.asarray(by["rama_coord"].consts["id"])
    layer = np.asarray(by["rama_map_pot"].consts["rama_map_id"])
    # the bundle marks the terminal angles' absent atoms in `dummy`
    inner = ~np.asarray(by["rama_coord"].consts["dummy"]).any(1)
    rng = np.random.default_rng(seed)
    pot = rng.uniform(0.0, 4.0, size=(layer.max() + 1, n_bin, n_bin))
    return (rc[inner], np.column_stack(
        [rc[inner, 4] + 1, np.full(inner.sum(), n_atom)]), layer[inner], pot)


def _trp():
    records, pos = bundle.load(TRP)
    rng = np.random.default_rng(4)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=(N_KEY,) + pos.shape)
    return records, pos, P


def test_pivot_tables_match_jax():
    records, pos, _ = _trp()
    tables = pivot_tables(records, len(pos))
    ours = PivotSampler.from_tables(*tables, device="cpu")
    ref = JPivot.from_tables(*tables)
    for name in ("rama_atom", "pivot_range", "restype"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      getattr(ref, name))
    for name in ("proposal_pot", "proposal_cdf"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   getattr(ref, name), rtol=1e-6, atol=0)
    assert ours.proposal_cdf[:, -1].eq(1.0).all()


def test_pivot_propose_matches_jax():
    records, pos, P = _trp()
    tables = pivot_tables(records, len(pos), seed=1)
    ours = PivotSampler.from_tables(*tables, device="cpu")
    ref = JPivot.from_tables(*tables)
    keys = jax.random.split(jax.random.PRNGKey(9), N_KEY)
    u = np.stack([np.asarray(jax.random.uniform(k, (4,), jnp.float64))
                  for k in keys])
    want = [ref.propose(k, jnp.asarray(P[i])) for i, k in enumerate(keys)]
    new, dl = ours.propose(torch.tensor(P), torch.tensor(u))
    np.testing.assert_allclose(new.numpy(),
                               np.stack([np.asarray(w[0]) for w in want]),
                               rtol=0, atol=1e-5)
    dl_j = np.array([float(w[1]) for w in want])
    np.testing.assert_allclose(dl.numpy(), dl_j, rtol=1e-6, atol=1e-6)
    moved = (new.numpy() != P).any(-1)
    assert moved.any(1).all() and not moved.all(1).any()


def _two_chains():
    b = ConfigBuilder(">x\nMKTAYIAKQRQISFVKSHFSRQ\n", seed=3)
    b.add_chain_breaks([9], jump_length_scale=4.0, jump_rotation_scale=25.0)
    jm = b.extra_input["jump_moves"]
    return b.pos.astype(np.float64), jm


def test_jump_propose_matches_jax_both_move_types():
    pos, jm = _two_chains()
    ref = JJump(jm["atom_range"], jm["sigma_trans"], jm["sigma_rot"])
    ours = JumpSampler.from_tables(jm["atom_range"], jm["sigma_trans"],
                                   jm["sigma_rot"], device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), N_KEY)
    draws, want = [], []
    for k in keys:
        k1, k2, k3 = jax.random.split(k, 3)
        draws.append((np.asarray(jax.random.uniform(k1, (2,), jnp.float64)),
                      np.asarray(jax.random.normal(k2, (3,), jnp.float64)),
                      np.asarray(jax.random.normal(k3, (4,), jnp.float64))))
        want.append(np.asarray(ref.propose(k, jnp.asarray(pos))[0]))
    d = tuple(torch.tensor(np.stack(x)) for x in zip(*draws))
    new, dl = ours.propose(torch.tensor(pos).expand(N_KEY, -1, -1), d)
    np.testing.assert_allclose(new.numpy(), np.stack(want), rtol=0,
                               atol=1e-5)
    assert not dl.any()
    types = (2.0 * d[0][:, 0]).long()
    chains = (2.0 * d[0][:, 1]).long()
    assert set(types.tolist()) == {0, 1} and set(chains.tolist()) == {0, 1}
    lo, hi = jm["atom_range"][chains.numpy()].T
    idx = np.arange(len(pos))
    for i in range(N_KEY):
        inside = (idx >= lo[i]) & (idx < hi[i])
        np.testing.assert_array_equal(new[i].numpy()[~inside], pos[~inside])
        # a rigid move keeps the chain's internal distances
        x = new[i].numpy()[inside]
        y = pos[inside]
        np.testing.assert_allclose(np.linalg.norm(x[1:] - x[:-1], axis=-1),
                                   np.linalg.norm(y[1:] - y[:-1], axis=-1),
                                   rtol=1e-10)


def test_metropolis_step_accepts_and_rejects_on_fixed_uniforms():
    """Energy sum |x|^2 under a translation move: with acceptance uniform
    0 every replica accepts; with uniform 1 a replica whose energy rises
    keeps its positions bit for bit.  The same decisions as JAX's
    `metropolis_step` where it draws these uniforms."""
    pos, jm = _two_chains()
    sampler = JumpSampler.from_tables(jm["atom_range"], jm["sigma_trans"],
                                      jm["sigma_rot"], device="cpu")
    B = 8
    x = torch.tensor(pos).expand(B, -1, -1).clone()
    gen = torch.Generator().manual_seed(3)
    prop = sampler.draw(B, gen, x.dtype, x.device)
    prop[0][:, 0] = 0.25                                # translations

    def energy(p):
        return p.pow(2).sum((-1, -2))

    new, _ = sampler.propose(x, prop)
    rises = energy(new) > energy(x)
    assert rises.any() and not rises.all()
    temp = torch.full((B,), 0.5, dtype=x.dtype)
    out, acc = metropolis_step(x, temp, energy, sampler,
                               draws=(prop, torch.zeros(B, dtype=x.dtype)))
    assert acc.all() and torch.equal(out, new)
    out, acc = metropolis_step(x, temp, energy, sampler,
                               draws=(prop, torch.ones(B, dtype=x.dtype)))
    assert torch.equal(acc, ~rises)
    assert torch.equal(out[rises], x[rises])
    assert torch.equal(out[~rises], new[~rises])

    jsampler = JJump(jm["atom_range"], jm["sigma_trans"], jm["sigma_rot"])
    for k in jax.random.split(jax.random.PRNGKey(5), 6):
        k_prop, k_acc = jax.random.split(k)
        k1, k2, k3 = jax.random.split(k_prop, 3)
        d = tuple(torch.tensor(np.asarray(f(kk, (n,), jnp.float64)))[None]
                  for f, kk, n in ((jax.random.uniform, k1, 2),
                                   (jax.random.normal, k2, 3),
                                   (jax.random.normal, k3, 4)))
        u = torch.tensor(np.asarray(jax.random.uniform(
            k_acc, dtype=jnp.float64)))[None]
        got, acc = metropolis_step(x[:1], temp[:1] * 40, energy, sampler,
                                   draws=(d, u))
        want, jacc = jmetropolis(k, jnp.asarray(pos), 20.0,
                                 lambda p: jnp.sum(p * p), jsampler)
        assert bool(acc[0]) == bool(jacc)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
