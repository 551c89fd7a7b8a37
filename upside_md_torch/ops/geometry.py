"""Vector geometry, batched over any leading axes (port of
upside_md_tpu/ops/geometry.py).  Derivatives come from autograd through the
same forward math."""

from __future__ import annotations

import math

import torch


def mag(v, dim=-1, keepdim=False):
    return torch.sqrt((v * v).sum(dim, keepdim=keepdim))


def normalized(v, dim=-1, eps=0.0):
    return v / (mag(v, dim, keepdim=True) + eps)


def dihedral(r1, r2, r3, r4):
    """Dihedral in (-pi, pi] with the reference's sign convention
    (src/vector_math.h:703-735): atan2(C.G, (A.B)|G|), F=r1-r2, G=r2-r3,
    H=r4-r3, A=FxG, B=HxG, C=BxA."""
    F, G, H = r1 - r2, r2 - r3, r4 - r3
    A = torch.cross(F, G, dim=-1)
    B = torch.cross(H, G, dim=-1)
    C = torch.cross(B, A, dim=-1)
    return torch.atan2((C * G).sum(-1), (A * B).sum(-1) * mag(G))


def wrap_angle(x):
    """Map an angle difference into (-pi, pi] by one period shift."""
    x = torch.where(x > math.pi, x - 2.0 * math.pi, x)
    return torch.where(x < -math.pi, x + 2.0 * math.pi, x)


def quat_to_rot(q):
    """Unit quaternion (..., 4) [a,b,c,d] -> rotation (..., 3, 3), the
    element layout of reference quat_to_rot (src/affine.h:98-108)."""
    a, b, c, d = q.unbind(-1)
    r = torch.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_rot(angle, axis):
    """Rotation (..., 3, 3) by `angle` (...) about the unit `axis` (..., 3)
    (reference axis_angle_to_rot, src/affine.h:49-64)."""
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    r = torch.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], dim=-1)
    return r.reshape(angle.shape + (3, 3))


def rotate_vec(R, v):
    """R (..., 3, 3) applied to v (..., 3)."""
    return (R * v.unsqueeze(-2)).sum(-1)


def max_eigvec_sym4(F, n_newton=25):
    """Largest eigenvalue and eigenvector of a batched symmetric traceless
    4x4: Newton on the characteristic quartic from the upper bound
    sqrt(tr F^2), then the eigenvector as the largest column of the
    Cayley-Hamilton adjugate of (F - lambda I).  Assumes a simple largest
    eigenvalue (reference src/eig.cpp:428-429)."""
    F2 = F @ F
    F3 = F2 @ F
    p2 = F2.diagonal(dim1=-2, dim2=-1).sum(-1)
    p3 = F3.diagonal(dim1=-2, dim2=-1).sum(-1)
    p4 = (F2 * F2.transpose(-1, -2)).sum((-1, -2))
    c2 = -0.5 * p2
    c1 = -p3 / 3.0
    c0 = 0.25 * (0.5 * p2 * p2 - p4)

    lam = torch.sqrt(torch.clamp(p2, min=1e-20))
    for _ in range(n_newton):
        P = ((lam * lam + c2) * lam + c1) * lam + c0
        dP = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - P / torch.where(dP.abs() > 1e-20, dP,
                                    torch.full_like(dP, 1e-20))

    eye = torch.eye(4, dtype=F.dtype, device=F.device)
    B = F - lam[..., None, None] * eye
    B2 = B @ B
    B3 = B2 @ B
    t1 = B.diagonal(dim1=-2, dim2=-1).sum(-1)
    t2 = B2.diagonal(dim1=-2, dim2=-1).sum(-1)
    t3 = B3.diagonal(dim1=-2, dim2=-1).sum(-1)
    b3 = -t1
    b2 = 0.5 * (t1 * t1 - t2)
    b1 = -(t1 ** 3 - 3.0 * t1 * t2 + 2.0 * t3) / 6.0
    adj = -(B3 + b3[..., None, None] * B2 + b2[..., None, None] * B
            + b1[..., None, None] * eye)
    best = (adj * adj).sum(-2).argmax(-1)                     # column
    col = torch.gather(adj, -1, best[..., None, None].expand(
        adj.shape[:-1] + (1,))).squeeze(-1)
    v = col / torch.sqrt(torch.clamp((col * col).sum(-1, keepdim=True),
                                     min=1e-30))
    return lam, v


def rigid_alignment(atoms, ref_geom):
    """Optimal rigid alignment per group (Coutsias quaternion RMSD).
    atoms (..., 3, 3) current N/CA/C; ref_geom (..., 3, 3) centered
    reference.  Returns (translation (..., 3), quaternion (..., 4)) with
    the quaternion rotating ref_geom onto the centered atoms; its sign is
    arbitrary (reference src/eig.cpp:277-386)."""
    center = atoms.mean(-2)
    x = atoms - center.unsqueeze(-2)
    R = (ref_geom.unsqueeze(-1) * x.unsqueeze(-2)).sum(-3)    # R[i,j]
    (R00, R01, R02), (R10, R11, R12), (R20, R21, R22) = [
        R[..., i, :].unbind(-1) for i in range(3)]
    F = torch.stack([
        torch.stack([R00 + R11 + R22, R12 - R21, R20 - R02, R01 - R10], -1),
        torch.stack([R12 - R21, R00 - R11 - R22, R01 + R10, R02 + R20], -1),
        torch.stack([R20 - R02, R01 + R10, -R00 + R11 - R22, R12 + R21], -1),
        torch.stack([R01 - R10, R02 + R20, R12 + R21, -R00 - R11 + R22], -1),
    ], dim=-2)
    _, quat = max_eigvec_sym4(F)
    return center, quat
