"""Analysis / diagnostics utilities (port of upside_md_tpu/analysis.py).

Files are read through the port's numpy-only HDF5 reader (`io/h5.py`);
the node profile and the energy attribution run on the port's `System`.
Replacements for the reference's small analysis scripts:
* attr_overview  (py/attr_overview.py)  — dump the HDF5 tree + attrs
* diagnose_traj  (py/diagnostic.py)     — hot-frame / kinetic-energy outliers
* energy_blame   (py/energy_blame.py)   — per-term and per-residue energy
                                          attribution at a configuration
* basic observables: radius of gyration, RMSD with optimal alignment
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .io import h5


def sim_timeseries(path, fields=("time", "potential", "kinetic",
                                 "temperature")):
    """Load per-frame scalar streams across the restart chain
    (py/sim_timeseries.py)."""
    from .io.trajectory import output_groups
    out = {}
    with h5.File(path) as f:
        for g in output_groups(f):
            for k in fields:
                if k in g:
                    out.setdefault(k, []).append(
                        np.asarray(g[k]).reshape(len(g[k]), -1))
    return {k: np.concatenate(v) for k, v in out.items()}


def add_image_points(rama, padding):
    """Periodic image augmentation for Rama KDE
    (py/estimate_rama_distributions.py:11-20)."""
    shifts = np.array([(i * 2 * np.pi, j * 2 * np.pi)
                       for i in (-1, 0, 1) for j in (-1, 0, 1)])
    new = np.concatenate([rama + s for s in shifts], axis=0)
    return new[np.all(np.abs(new) < np.pi + padding, axis=-1)]


def rama_density(rama, bandwidth=0.2, padding=80 * np.pi / 180.0,
                 n_bins=72):
    """Gaussian-KDE Rama density on the reference 72x72 5-degree grid
    (py/estimate_rama_distributions.py:23-33)."""
    pts = add_image_points(np.asarray(rama, np.float64), padding)
    bins = (-180.0 + np.arange(n_bins) * (360.0 / n_bins)) * np.pi / 180.0
    gx, gy = np.meshgrid(bins, bins)
    grid = np.column_stack([gx.ravel(), gy.ravel()])
    # plain Gaussian KDE (scikit-free)
    d2 = ((grid[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    dens = np.exp(-0.5 * d2 / bandwidth ** 2).sum(1)
    dens /= len(pts) * 2 * np.pi * bandwidth ** 2
    return dens.reshape(n_bins, n_bins)


def infer_amide_hydrogens(C, N, CA):
    """H position from prev-C, N, CA (py/analyze_rdc.py:11-14)."""
    def vhat(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    return N - 0.88 * vhat(vhat(CA - N) + vhat(C - N))


def rdc(pos):
    """N-H residual dipolar couplings P2(cos theta) against the inertial
    principal axes (py/analyze_rdc.py:17-52)."""
    pos = np.asarray(pos, np.float64)
    pos = pos - pos.mean(0)
    N, CA, C = pos[0::3], pos[1::3], pos[2::3]
    H = infer_amide_hydrogens(C[:-1], N[1:], CA[1:])
    H_dir = H - N[1:]
    H_dir /= np.linalg.norm(H_dir, axis=-1, keepdims=True)

    it = np.mean((pos ** 2).sum(-1)) * np.eye(3) - \
        (pos[:, None, :] * pos[:, :, None]).mean(0)
    evals, evecs = np.linalg.eigh(it)

    def P2(c):
        return 1.5 * c ** 2 - 0.5
    return [(evals[i], P2(H_dir @ evecs[:, i])) for i in range(3)]


def attr_overview(path):
    """Readable dump of the config tree (datasets, shapes, attrs)."""
    lines = []

    def visit(name, obj):
        if isinstance(obj, h5.Dataset):
            lines.append(f"{name}  {obj.shape} {obj.dtype}")
        for k, v in sorted(obj.attrs.items()):
            lines.append(f"{name}@{k} = {v!r}")

    with h5.File(path) as f:
        f.visititems(visit)
    return "\n".join(lines)


def radius_of_gyration(pos):
    """pos (..., n_atom, 3) -> Rg (...)."""
    com = pos.mean(axis=-2, keepdims=True)
    return np.sqrt(((pos - com) ** 2).sum(-1).mean(-1))


def rmsd(pos, ref):
    """Optimal-superposition RMSD via the Kabsch/quaternion method."""
    from .ops.geometry import max_eigvec_sym4

    pos = np.asarray(pos, np.float64)
    ref = np.asarray(ref, np.float64)
    x = pos - pos.mean(-2, keepdims=True)
    y = ref - ref.mean(-2, keepdims=True)
    R = np.einsum('...ai,...aj->...ij', y, x)
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    F = np.stack([
        np.stack([R00 + R11 + R22, R12 - R21, R20 - R02, R01 - R10], -1),
        np.stack([R12 - R21, R00 - R11 - R22, R01 + R10, R02 + R20], -1),
        np.stack([R20 - R02, R01 + R10, -R00 + R11 - R22, R12 + R21], -1),
        np.stack([R01 - R10, R02 + R20, R12 + R21, -R00 - R11 + R22], -1),
    ], axis=-2)
    lam = max_eigvec_sym4(torch.as_tensor(F))[0].numpy()
    msd = (np.sum(x * x, (-2, -1)) + np.sum(y * y, (-2, -1))
           - 2.0 * lam) / pos.shape[-2]
    return np.sqrt(np.maximum(msd, 0.0))


def diagnose_traj(path, ke_sigma=4.0):
    """Flag frames whose kinetic energy is a >ke_sigma outlier — the
    reference's hot-frame detector (py/diagnostic.py)."""
    with h5.File(path) as f:
        ke = np.asarray(f["output/kinetic"]).reshape(-1)
    mu, sd = ke.mean(), ke.std()
    hot = np.where(ke > mu + ke_sigma * sd)[0]
    return {"mean_ke": float(mu), "std_ke": float(sd),
            "hot_frames": hot.tolist()}


def profile_nodes(system, params, pos, reps=20):
    """Per-node time, the reference's COLLECT_PROFILE report
    (src/timing.cpp:11-53): each node's compute is run alone on its real
    inputs (from one evaluation of the graph at `pos`, (n_atom, 3) or
    (B, n_atom, 3)) `reps` times after one warm-up call, timed between
    CUDA events on the card and with `time.perf_counter` on the CPU.  The
    fused pair block, which the nodes of its plan read, is a row of its
    own.  Returns a list of (name, microseconds, percent) sorted by
    cost."""
    import time

    params = system.params if params is None else params
    pos = torch.as_tensor(pos, dtype=system.dtype,
                          device=system.device)
    pos = pos[None] if pos.ndim == 2 else pos
    cuda = pos.is_cuda
    with torch.no_grad():
        _, outputs, _, ctx = system.evaluate(pos, params=params)
        spec = system.stacked_leaves(params)
        calls = []
        fusion = system.pair_fusion
        if fusion is not None:
            prep = system.fused_prepared(params)
            calls.append(("(fused pair block)", lambda: fusion.compute(
                system.consts, outputs, prep, params, system.plain,
                system.residuals)))
        for s in system.specs:
            def call(s=s):
                ctx.node_name = s.name
                ctx.stacked = frozenset(k for n, k in spec if n == s.name)
                return s.node_type.compute(
                    system.consts[s.name], params.get(s.name, {}),
                    [outputs[a] for a in s.args], ctx)
            calls.append((s.name, call))
        rows = []
        for name, fn in calls:
            fn()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                end.synchronize()
                us = start.elapsed_time(end) * 1e3 / reps
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                us = (time.perf_counter() - t0) * 1e6 / reps
            rows.append([name, us])
    total = sum(r[1] for r in rows)
    rows = [(name, us, 100.0 * us / max(total, 1e-12))
            for name, us in rows]
    return sorted(rows, key=lambda r: -r[1])


def print_profile_report(rows):
    print(f"{'node':40s} {'us/call':>10s} {'%':>6s}")
    for name, us, pct in rows:
        print(f"{name:40s} {us:10.1f} {pct:6.1f}")


def energy_blame(system, params, pos) -> Dict[str, float]:
    """Per-term energy attribution at one configuration (n_atom, 3)
    (py/energy_blame.py)."""
    x = torch.as_tensor(pos, dtype=system.dtype,
                        device=system.device)
    with torch.no_grad():
        per_term = system.evaluate(x[None], params=params)[2]
    return {k: float(v[0]) for k, v in per_term.items()}
