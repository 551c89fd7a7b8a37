"""The fixed-order sums that replaced float scatters and a batch-dependent
reduction, each against the form it replaced, on the CPU in float64 (where
both are exact up to the order of the additions), on the trp-cage bundle:

* `table_cotangent` (ops/fused_pair.py; training's table cotangents)
  against its former `index_add_` by (type1, type2), in one replica chunk
  and in two: rel 1e-12;
* on CPU tensors `table_cotangent` is its plain version and a table's
  gradient through the fused block (the training cell's three tables)
  launches no kernel; the table cotangent's kernel is in `KERNELS`, with
  its C entry point in `csrc/table_cotangent.cu`, and so are the
  neighbour lists' two (`csrc/nlist_spline.cu`);
* on CPU tensors, `plain` or not, `quadspline_coverage_nl` is its plain
  version, values and gradients equal, and launches no kernel;
* `env_table_cotangent` (the environment table's cotangent, summed by
  type with one-hot products) against its former autograd through the
  table gather (an accumulating `index_put_`): rel 1e-12;
* `coverage_nl` (nodes/hbond.py; the coverages past 1,024 columns), at a
  neighbour width of 8 so rows overflow, against its former
  `scatter_add` into the columns: rel 1e-12;
* `contact_energy_per_bead` (nodes/radial.py; the contact_energy stream)
  on the extras bundle and on a list whose beads meet three and four
  times, against its former pair of `index_add`s: equal;
* `backbone_pairs` (nodes/steric.py) against its former `.sum((-1, -2))`
  (rel 1e-12), `halving_sum` and its backward against `sum`'s at awkward
  widths, and a
  replica's float32 energy bitwise the same alone, in a batch of 3 and of
  16.
"""

import os

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse)
from upside_md_torch import DATA_DIR
from upside_md_torch.nodes import hbond, radial, steric
from upside_md_torch.ops import fused_pair, kernels
from upside_md_torch.ops.pairs import (quadspline_coverage_nl,
                                      quadspline_coverage_nl_plain,
                                      quadspline_family, type_members)
from upside_md_torch.ops.spline import bspline_window_weights
from upside_md_torch.system import System

TRP = os.path.join(DATA_DIR, "trp_cage_full_synth.npz")
EXTRAS = os.path.join(DATA_DIR, "trp_cage_extras_synth.npz")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.fixture(scope="module")
def trp():
    system, pos = System.from_bundle(TRP, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(2)
    x = pos[None] + 0.1 * torch.randn((3,) + pos.shape, generator=gen,
                                      dtype=pos.dtype)
    with torch.no_grad():
        outs = system.evaluate(x)[1]
    return system, x, outs


def table_cotangent_index_add(table, t1, t2, x1, x2, mask, g):
    """`table_cotangent` as it was: each pair's cotangent scattered to its
    (type1, type2) entry by `index_add_`."""
    ka, k, dx = quadspline_family(table.shape[-1])
    inv_dx, inv_dth = 1.0 / dx, (ka - 3) / 2.0
    A, Bt, M = table.shape
    t1, t2 = t1.long(), t2.long()
    p = table.detach()[t1[:, None], t2[None, :]]
    idx = (t1[:, None] * Bt + t2[None, :]).reshape(-1)
    out = table.new_zeros((A * Bt, M))
    _, dist, _, cos1, cos2 = fused_pair._geometry(x1, x2)
    s = dist * inv_dx
    live = mask.bool() & (s < k - 2 - 1e-6)
    gm = torch.where(live, g, torch.zeros_like(s))
    wa1 = bspline_window_weights((cos1 + 1.0) * inv_dth + 1.0, ka, False)
    wa2 = bspline_window_weights((cos2 + 1.0) * inv_dth + 1.0, ka, False)
    wd = bspline_window_weights(s, k, True)
    a1 = (wa1 * p[..., :ka]).sum(-1)
    a2 = (wa2 * p[..., ka:2 * ka]).sum(-1)
    narrow = (wd * p[..., 2 * ka + k:]).sum(-1)
    gw = torch.cat([(gm * a2 * narrow)[..., None] * wa1,
                    (gm * a1 * narrow)[..., None] * wa2,
                    gm[..., None] * wd,
                    (gm * a1 * a2)[..., None] * wd], dim=-1)
    out.index_add_(0, idx, gw.sum(0).reshape(-1, M))
    return out.reshape(A, Bt, M)


def _coverage_operands(system, outs, name):
    spec = system.by_name[name]
    c = system.consts[name]
    x1 = outs[spec.args[0]][:, c["index1"]]
    x2 = outs[spec.args[1]][:, c["index2"]]
    return c, system.params[name]["interaction_param"], x1, x2


@pytest.mark.parametrize("chunk", [8, 2])
@pytest.mark.parametrize("name", ["hbond_coverage",
                                  "hbond_coverage_hydrophobe"])
def test_table_cotangent_equals_index_add(trp, name, chunk, monkeypatch):
    """Chunk 2 splits the 3 replicas: the chunks' sums add before the sum
    by type."""
    monkeypatch.setattr(fused_pair, "COTANGENT_CHUNK", chunk)
    system, _, outs = trp
    c, table, x1, x2 = _coverage_operands(system, outs, name)
    g = torch.randn(x1.shape[0], x1.shape[1], x2.shape[1],
                    generator=torch.Generator().manual_seed(3),
                    dtype=x1.dtype)
    args = (table, c["type1"], c["type2"], x1[..., :6], x2[..., :6],
            c["spline"].mask, g)
    new = fused_pair.table_cotangent(*args)
    old = table_cotangent_index_add(*args)
    assert new.shape == old.shape == table.shape
    assert _rel(new, old) < 1e-12


def _refuse_launch(name, *args):
    raise AssertionError(f"{name} launched on CPU tensors")


def test_table_cotangent_on_cpu_tensors_is_plain(trp, monkeypatch):
    """CPU tensors take the plain version, `plain` or not: the kernels'
    launcher, patched to raise, is never called."""
    monkeypatch.setattr(kernels, "launch", _refuse_launch)
    system, _, outs = trp
    c, table, x1, x2 = _coverage_operands(system, outs, "hbond_coverage")
    g = torch.randn(x1.shape[0], x1.shape[1], x2.shape[1],
                    generator=torch.Generator().manual_seed(5),
                    dtype=x1.dtype)
    args = (table, c["type1"], c["type2"], x1[..., :6], x2[..., :6],
            c["spline"].mask, g)
    want = fused_pair.table_cotangent_plain(*args)
    assert want.abs().max() > 0
    for plain in (False, True):
        assert torch.equal(fused_pair.table_cotangent(*args, plain=plain),
                           want)


@pytest.mark.parametrize("node", ["rotamer", "hbond_coverage",
                                  "hbond_coverage_hydrophobe"])
def test_table_gradient_on_cpu_tensors_launches_nothing(trp, node,
                                                        monkeypatch):
    """A pair table's gradient through the fused block on CPU tensors
    (`block_table_cotangents` in its backward) launches no kernel, and is
    finite and not zero."""
    monkeypatch.setattr(kernels, "launch", _refuse_launch)
    system, x, _ = trp
    assert system.pair_fusion is not None
    grad = system.param_deriv(x, node)["interaction_param"]
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


@pytest.mark.parametrize("name, source", [
    ("table_cotangent", "table_cotangent.cu"),
    ("nlist_spline_fwd", "nlist_spline.cu"),
    ("nlist_spline_bwd", "nlist_spline.cu")])
def test_table_cotangent_has_its_c_entry_point(name, source):
    """Each of the kernels `kernels.launch` calls for the table cotangents
    and the neighbour lists' pair spline is in `KERNELS`, declared
    `extern "C" int <name>(` in its source."""
    assert name in kernels.KERNELS
    with open(os.path.join(kernels.CSRC, source)) as fh:
        assert f'extern "C" int {name}(' in fh.read()


def test_coverage_nl_on_cpu_tensors_launches_nothing(trp, monkeypatch):
    """`quadspline_coverage_nl` on CPU tensors, `plain` or not, is its
    plain version: values and the gradients of the sites and the table
    equal to `quadspline_coverage_nl_plain`'s, at a neighbour width of 8
    that some rows fill, and the kernels' launcher, patched to raise, is
    never called."""
    monkeypatch.setattr(kernels, "launch", _refuse_launch)
    system, _, outs = trp
    c, table, x1, x2 = _coverage_operands(system, outs, "hbond_coverage")
    ka, k, dx = quadspline_family(table.shape[-1])
    g = torch.randn(x1.shape[0], x1.shape[1], 8, dtype=x1.dtype,
                    generator=torch.Generator().manual_seed(6))

    def run(fn, **kw):
        a = x1[..., :6].detach().requires_grad_(True)
        b = x2[..., :6].detach().requires_grad_(True)
        t = table.detach().requires_grad_(True)
        cov, idx, mask = fn(t, c["type1"], c["type2"], a[..., :3],
                            a[..., 3:], b[..., :3], b[..., 3:], ka, k,
                            1.0 / dx, c["spline"].mask.bool(), 8, **kw)
        return (cov, idx, mask) + torch.autograd.grad((cov * g).sum(),
                                                      (a, b, t))

    want = run(quadspline_coverage_nl_plain)
    assert (want[2].sum(-1) == 8).any() and want[5].abs().max() > 0
    for plain in (False, True):
        got = run(quadspline_coverage_nl, plain=plain, spline=c["spline"])
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_type_members():
    t = torch.tensor([2, 0, 2, 2, 1, 0])
    np.testing.assert_array_equal(type_members(t, 4).numpy(),
                                  [[1, 5, 6], [4, 6, 6], [0, 2, 3],
                                   [6, 6, 6]])


def test_env_table_cotangent_equals_index_put(trp):
    system, x, outs = trp
    plan, prep = system.pair_fusion, system.fused_prepared()
    assert prep.r_p > prep.r_e                  # the bundle has an env band
    x1, _, x2, wcol = plan.block_inputs(system.consts, outs)
    tab4 = plan.tables(system.params)[3]
    rt = prep.row_type.long()
    g_env = torch.randn((x.shape[0], prep.r_p - prep.r_e), dtype=x.dtype,
                        generator=torch.Generator().manual_seed(4))
    args = (tab4, rt[prep.r_e:prep.r_p], prep.col_type[2],
            prep.mask[prep.r_e:prep.r_p], x1[:, prep.r_e:prep.r_p], wcol, x2,
            g_env)
    new = fused_pair.env_table_cotangent(*args)
    t = tab4.detach().requires_grad_(True)
    prm = t[args[1][:, None], args[2].long()[None, :]]
    (old,) = torch.autograd.grad(
        (g_env * fused_pair.env_rowsums(prm, *args[3:7])).sum(), t)
    assert new.shape == old.shape == tab4.shape
    assert old.abs().max() > 0 and _rel(new, old) < 1e-12


def test_coverage_nl_equals_scatter_add(trp, monkeypatch):
    monkeypatch.setattr(hbond, "COVERAGE_NEIGHBOR_K", 8)
    system, _, outs = trp
    c, table, x1, x2 = _coverage_operands(system, outs, "hbond_coverage")
    w1 = (1.0 - x1[..., 6]) ** 2
    new = hbond.coverage_nl(c, table, x1[..., :6], x2[..., :6], w1)
    ka, k, dx = quadspline_family(table.shape[-1])
    cov, idx, mask = quadspline_coverage_nl(
        table, c["type1"], c["type2"], x1[..., 0:3], x1[..., 3:6],
        x2[..., 0:3], x2[..., 3:6], ka, k, 1.0 / dx,
        c["spline"].mask.bool(), 8)
    assert (mask.sum(-1) == 8).any()      # some rows fill the list
    B, n2 = x2.shape[:2]
    val = torch.where(mask, w1[..., None] * cov, torch.zeros_like(cov))
    safe = torch.where(mask, idx, torch.full_like(idx, n2))
    old = val.new_zeros((B, n2 + 1)).scatter_add(
        1, safe.reshape(B, -1), val.reshape(B, -1))[:, :n2]
    assert new.shape == old.shape and _rel(new, old) < 1e-12


def _contact_index_add(c, p, x):
    en = 0.5 * radial._contact_values(c, p, x)
    ids = c["id"]
    return en.new_zeros(x.shape[:2]).index_add(1, ids[:, 0], en).index_add(
        1, ids[:, 1], en)


def test_contact_stream_equals_index_add():
    system, pos = System.from_bundle(EXTRAS, "cpu", torch.float64)
    spec = system.by_name["contact"]
    with torch.no_grad():
        x = system.evaluate(pos[None])[1][spec.args[0]]
    c, p = system.consts["contact"], system.params["contact"]
    new = radial.contact_energy_per_bead(c, p, [x])
    assert torch.equal(new, _contact_index_add(c, p, x))
    ids = np.array([[0, 3], [3, 5], [0, 5], [3, 7], [2, 3], [5, 0]])
    c = radial._prepare_contact({"id": ids}, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(4)
    p = {k: torch.rand(len(ids), generator=gen, dtype=torch.float64) + 1
         for k in ("distance", "energy", "width")}
    x = 2.0 * torch.randn(2, 9, 3, generator=gen, dtype=torch.float64)
    new = radial.contact_energy_per_bead(c, p, [x])
    assert new.shape == (2, 9)
    assert torch.equal(new, _contact_index_add(c, p, x))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 77, 416])
def test_halving_sum(n):
    x = torch.randn(4, n, generator=torch.Generator().manual_seed(n),
                    dtype=torch.float64, requires_grad=True)
    total = steric.halving_sum(x)
    assert torch.allclose(total, x.sum(-1), rtol=1e-13, atol=1e-13)
    # its backward is the sum's: the cotangent broadcast over the dim
    g = torch.arange(1.0, 5.0, dtype=torch.float64)
    (dx,) = torch.autograd.grad(total, x, g)
    assert torch.equal(dx, g[:, None].expand(4, n))


def test_backbone_pairs_fixed_order(trp):
    system, x, outs = trp
    spec = system.by_name["backbone_pairs"]
    c, p = system.consts["backbone_pairs"], system.params["backbone_pairs"]
    inputs = [outs[a] for a in spec.args]
    new = steric._backbone_pairs(c, p, inputs, None)
    # the former sum over the whole grid
    affine = inputs[0][:, c["id"]]
    R = steric.quat_to_rot(affine[..., 3:7])
    atoms = steric.rotate_vec(R.unsqueeze(-3), c["ref_pos"]) \
        + affine[..., None, 0:3]
    ax = atoms.reshape(atoms.shape[0], -1, 3)
    d = ax.unsqueeze(1) - ax.unsqueeze(2)
    v, _ = steric.compact_sigmoid((d * d).sum(-1) - steric.WALL2,
                                  steric.SHARPNESS)
    old = steric.ENERGY_SCALE * torch.where(
        c["pair_mask"], v, torch.zeros_like(v)).sum((-1, -2))
    assert (old > 0).all() and _rel(new, old) < 1e-12
    # float32: one replica's energy does not depend on its batch
    system32 = System(system.n_atom, system.specs, "cpu")
    c32 = system32.consts["backbone_pairs"]
    aff = inputs[0].float()
    batch = torch.cat([aff] * 6)[:16]
    alone = steric._backbone_pairs(c32, {}, [aff[:1]], None)
    for n in (3, 16):
        got = steric._backbone_pairs(c32, {}, [batch[:n]], None)
        assert torch.equal(got[0], alone[0])
