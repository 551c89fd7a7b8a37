"""upside_md_torch/ops against their JAX twins (upside_md_tpu/ops) and the
C++-transliterated goldens.

Inputs are made with numpy from a seed and go through both frameworks in
float32; the comparisons hold at rel 1e-5 (atol 1e-6 where values cross
zero), the f32 rounding of two evaluation orders of the same formula.
The golden checks run the port in float64 at the goldens' own tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from upside_md_tpu.ops import geometry as jgeo
from upside_md_tpu.ops import pairs as jpairs
from upside_md_tpu.ops import sigmoid as jsig
from upside_md_tpu.ops import spline as jspline
from upside_md_torch.ops import geometry as tgeo
from upside_md_torch.ops import pairs as tpairs
from upside_md_torch.ops import sigmoid as tsig
from upside_md_torch.ops import spline as tspline

F32 = dict(rtol=1e-5, atol=1e-6)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def j32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got, np.float64), np.asarray(want, np.float64),
        **(tol or F32))


def unit_rows(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("clamped", [True, False])
def test_clamped_spline_and_window_weights(rng, clamped):
    coeffs = rng.normal(size=(5, 11))
    x = rng.uniform(-1.0, 11.0, size=(5,)) if clamped else \
        rng.uniform(1.0, 8.99, size=(5,))
    if clamped:
        v, d = tspline.eval_clamped_bspline(t32(coeffs), t32(x))
        jv, jd = jspline.eval_clamped_bspline(j32(coeffs), j32(x))
    else:
        v, d = tspline.eval_bspline(t32(coeffs), t32(x))
        jv, jd = jspline.eval_bspline(j32(coeffs), j32(x))
    close(v, jv)
    close(d, jd)
    W = tspline.bspline_window_weights(t32(x), 11, clamped)
    close(W, jspline.bspline_window_weights(j32(x), 11, clamped))


def test_periodic_spline_2d(rng):
    coeffs = rng.normal(size=(7, 12, 10))
    x = rng.uniform(0.0, 12.0, size=(3, 7))
    y = rng.uniform(0.0, 10.0, size=(3, 7))
    got = tspline.eval_periodic_bspline_2d(t32(coeffs), t32(x), t32(y))
    want = jspline.eval_periodic_bspline_2d(j32(coeffs), j32(x), j32(y))
    for g, w in zip(got, want):
        close(g, w)


def test_splines_vs_goldens():
    from test_reference_goldens import (C8, C9, CLAMPED_GOLDEN,
                                        UNCLAMPED_GOLDEN)
    from test_reference_goldens2 import PER2D_DATA, PER2D_GOLDEN
    c9 = torch.as_tensor(np.asarray(C9, np.float64))
    for x, v, d in CLAMPED_GOLDEN:
        gv, gd = tspline.eval_clamped_bspline(
            c9, torch.tensor(x, dtype=torch.float64))
        np.testing.assert_allclose([gv.item(), gd.item()], [v, d],
                                   rtol=1e-10, atol=1e-12)
    c8 = torch.as_tensor(np.asarray(C8, np.float64))
    for x, v, d in UNCLAMPED_GOLDEN:
        gv, gd = tspline.eval_bspline(c8, torch.tensor(x, dtype=torch.float64))
        np.testing.assert_allclose([gv.item(), gd.item()], [v, d],
                                   rtol=1e-10, atol=1e-12)
    coeffs = torch.as_tensor(jspline.fit_periodic_bspline_2d(
        np.asarray(PER2D_DATA)))
    for x, y, v, dx, dy in PER2D_GOLDEN:
        got = tspline.eval_periodic_bspline_2d(
            coeffs, torch.tensor([x], dtype=torch.float64),
            torch.tensor([y], dtype=torch.float64))
        np.testing.assert_allclose([g.item() for g in got], [v, dx, dy],
                                   rtol=1e-9, atol=1e-12)


def test_sigmoids(rng):
    x = rng.normal(scale=2.0, size=(40,))
    s = rng.uniform(0.3, 3.0, size=(40,))
    for g, w in zip(tsig.compact_sigmoid(t32(x), t32(s)),
                    jsig.compact_sigmoid(j32(x), j32(s))):
        close(g, w)
    from test_reference_goldens2 import CS_GOLDEN
    for x, s, v, d in CS_GOLDEN:
        gv, gd = tsig.compact_sigmoid(torch.tensor(x, dtype=torch.float64),
                                      torch.tensor(s, dtype=torch.float64))
        np.testing.assert_allclose([gv.item(), gd.item()], [v, d],
                                   rtol=1e-12, atol=1e-14)


def test_geometry(rng):
    pts = rng.normal(size=(4, 9, 3))
    close(tgeo.dihedral(*[t32(p) for p in pts]),
          jgeo.dihedral(*[j32(p) for p in pts]))
    q = rng.normal(size=(9, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    close(tgeo.quat_to_rot(t32(q)), jgeo.quat_to_rot(j32(q)))
    ang = rng.uniform(-7, 7, size=(20,))
    close(tgeo.wrap_angle(t32(ang)), jgeo.wrap_angle(j32(ang)))


def test_rigid_alignment(rng):
    ref = rng.normal(size=(6, 3, 3))
    ref -= ref.mean(-2, keepdims=True)
    rot = jgeo.quat_to_rot(j32(unit_rows(rng, 6) @ np.eye(3, 4)
                               + 0.3 * rng.normal(size=(6, 4))))
    rot = np.asarray(rot) / np.linalg.norm(np.asarray(rot), axis=-1,
                                           keepdims=True)
    atoms = np.einsum("nij,naj->nai", rot, ref) + rng.normal(size=(6, 1, 3)) \
        + 0.05 * rng.normal(size=(6, 3, 3))
    c, q = tgeo.rigid_alignment(t32(atoms), t32(ref))
    jc, jq = jgeo.rigid_alignment(j32(atoms), j32(ref))
    close(c, jc)
    # quaternion sign is arbitrary: compare up to sign
    sign = np.sign(np.sum(q.numpy() * np.asarray(jq), -1, keepdims=True))
    close(q * torch.as_tensor(sign), jq)


def test_rigid_alignment_vs_golden():
    from test_reference_goldens3 import (AF_ATOMS, AF_CENTER, AF_GRAD,
                                         AF_QC, AF_QUAT, AF_REF, AF_SENS3)
    atoms = torch.tensor(np.asarray(AF_ATOMS, np.float64),
                         requires_grad=True)
    ref = torch.tensor(np.asarray(AF_REF, np.float64))
    center, quat = tgeo.rigid_alignment(atoms, ref)
    np.testing.assert_allclose(center.detach().numpy(), AF_CENTER,
                               rtol=1e-12)
    dot = float((quat.detach() * torch.tensor(AF_QUAT)).sum())
    np.testing.assert_allclose(abs(dot), 1.0, atol=1e-7)
    loss = (torch.tensor(AF_SENS3) * center).sum() \
        + np.sign(dot) * (torch.tensor(AF_QC) * quat).sum()
    (g,) = torch.autograd.grad(loss, atoms)
    np.testing.assert_allclose(g.numpy(), AF_GRAD, rtol=1e-6, atol=1e-8)


def test_pairs(rng):
    id1 = rng.integers(0, 12, 9)
    id2 = rng.integers(0, 12, 11)
    m = tpairs.sequence_exclusion_mask(torch.as_tensor(id1),
                                       torch.as_tensor(id2), 2)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jpairs.sequence_exclusion_mask(id1, id2, 2)))
    for n in (34, 30, 62, 54, 40):
        assert tpairs.quadspline_family(n) == jpairs.quadspline_family(n)

    ka, k = 8, 9
    table = 0.3 * rng.normal(size=(3, 4, 2 * ka + 2 * k))
    t1 = rng.integers(0, 3, 9)
    t2 = rng.integers(0, 4, 11)
    f1 = np.concatenate([2.5 * rng.normal(size=(9, 3)), unit_rows(rng, 9)], 1)
    f2 = np.concatenate([2.5 * rng.normal(size=(11, 3)), unit_rows(rng, 11)],
                        1)
    got = tpairs.pair_coverage(t32(table), torch.as_tensor(t1),
                               torch.as_tensor(t2), t32(f1), t32(f2), m,
                               ka, k, 1.0)
    want = jpairs.pair_coverage(j32(table), t1, t2, j32(f1), j32(f2),
                                jnp.asarray(np.asarray(m)), ka, k, 1.0)
    close(got, want)
    assert np.count_nonzero(np.asarray(want)) > 5
