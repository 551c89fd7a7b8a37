"""The compact residual of K1 (`ops/fused_pair.py`: `pack_residuals`,
`unpack_residuals`) and the plain forward restricted to the culled tiles,
on the CPU.

K1's forward kernel keeps, per 32 x 32 tile, only its live pairs' codes
and derivatives, and its backward reads nothing else; the plain twins go
between that layout and the plain version's dense planes.  What holds here
for them holds for the kernels, which the card tests hold to them
(tests/test_torch_kernels_cuda.py, chip_smoke.py): their counts and codes
equal `pack_residuals` of the plain forward exactly.  Every test runs on
both band layouts (with and without the env band) and on two seeded
problems, beads along a chain of 3.8 A steps (few tiles culled) and of
12 A steps (many culled).
"""

import pytest
import torch

import test_torch_kernels_cuda as kc
from upside_md_torch.ops import fused_pair as fp
from upside_md_torch.ops import tile_cull as tc

CPU = torch.device("cpu")
CASES = pytest.mark.parametrize("seed,step", [(0, 3.8), (1, 12.0)])
BANDS = pytest.mark.parametrize("env_band", [True, False])


def _case(seed, step, env_band):
    prep, x = kc.fused_case(seed, env_band, step, CPU)
    cov, grid, env, planes, vcov = fp.fused_pair_fwd_plain(prep, *x)
    return prep, x, planes, vcov


@BANDS
@CASES
def test_round_trip_gives_the_dense_planes(seed, step, env_band):
    """unpack(pack(planes, vcov)) is the plain forward's planes and vcov:
    the same values at the live pairs and zeros elsewhere."""
    prep, x, planes, vcov = _case(seed, step, env_band)
    packed = fp.pack_residuals(prep, x[0], x[2], planes, vcov)
    back_planes, back_vcov = fp.unpack_residuals(prep, packed)
    live = fp.live_pairs(prep, x[0], x[2])
    assert live.any()
    assert torch.equal(back_planes, planes) and torch.equal(back_vcov, vcov)
    assert torch.equal(back_planes[live.unsqueeze(1).expand_as(planes)],
                       planes[live.unsqueeze(1).expand_as(planes)])
    assert not back_planes[~live.unsqueeze(1).expand_as(planes)].any()
    assert not back_vcov[~live[:, :prep.r_e]].any()
    counts, codes, vals = packed
    assert counts.dtype == codes.dtype == torch.int16
    assert vals.shape == codes.shape + (4,)
    # the value slot holds the coverage value, 0 on the bead band
    rows = fp._to_tiles(torch.arange(prep.n1)[None, :, None].expand(
        live.shape), *counts.shape[1:])
    valid = fp.residual_slots(counts)
    bead = torch.gather(rows, -1, codes.long()) >= prep.r_p
    assert not vals[..., 3][valid & bead].any()


@BANDS
@CASES
def test_codes_are_row_major_in_tile_order(seed, step, env_band):
    """Within a tile the codes (row * 32 + column) rise; over the tiles in
    order they list every live pair once, tile by tile."""
    prep, x, planes, vcov = _case(seed, step, env_band)
    counts, codes, _ = fp.pack_residuals(prep, x[0], x[2], planes, vcov)
    valid = fp.residual_slots(counts)
    B, n_rt, n_ct = counts.shape
    got = []
    for b in range(B):
        for rt in range(n_rt):
            for ct in range(n_ct):
                c = codes[b, rt, ct][valid[b, rt, ct]].long()
                assert (c[1:] > c[:-1]).all()
                assert not codes[b, rt, ct][~valid[b, rt, ct]].any()
                got += [(b, rt * 32 + int(k) // 32, ct * 32 + int(k) % 32)
                        for k in c]
    live = fp.live_pairs(prep, x[0], x[2])
    b, i, j = torch.nonzero(live, as_tuple=True)
    want = sorted(zip(b.tolist(), i.tolist(), j.tolist()),
                  key=lambda p: (p[0], p[1] // 32, p[2] // 32, p[1], p[2]))
    assert got == want


@BANDS
@CASES
def test_counts_are_the_live_pairs_of_the_kept_tiles(seed, step, env_band):
    """Each tile's count is its live pairs (`_spline_fields`' live mask)
    inside the tiles `cull_tiles` keeps; a culled tile counts 0."""
    prep, x, planes, vcov = _case(seed, step, env_band)
    counts = fp.pack_residuals(prep, x[0], x[2], planes, vcov).counts
    keep = fp.cull_tiles(prep, x[0], x[2])
    live = fp._spline_fields(prep, x[0], x[2])[1] \
        & tc.pair_keep(keep, prep.n1, prep.n2)
    want = fp._to_tiles(live, *keep.shape[1:]).sum(-1)
    assert torch.equal(counts.long(), want)
    assert not counts[~keep].any()
    if step > 10.0:
        assert not keep.all()


@BANDS
@CASES
def test_backward_from_the_packed_residual_is_exact(seed, step, env_band):
    """The plain K1 backward from the unpacked planes, and the wrapper
    given the packed residual on the CPU, equal the backward from the
    dense planes bit for bit; the plain forward refuses tile flags."""
    prep, x, planes, vcov = _case(seed, step, env_band)
    packed = fp.pack_residuals(prep, x[0], x[2], planes, vcov)
    fwd = fp.fused_pair_fwd_plain(prep, *x)
    gen = torch.Generator().manual_seed(seed + 10)
    g = [torch.randn(t.shape, generator=gen) for t in fwd[:3]]
    dense = fp.fused_pair_bwd_plain(prep, *x, planes, vcov, *g)
    assert dense[0].abs().max() > 0
    for got in (fp.fused_pair_bwd_plain(prep, *x,
                                        *fp.unpack_residuals(prep, packed),
                                        *g),
                fp.fused_pair_bwd(prep, *x, packed, *g)):
        assert all(torch.equal(a, b) for a, b in zip(got, dense))
    flags = torch.zeros(packed.counts.shape, dtype=torch.uint8)
    with pytest.raises(ValueError):
        fp.fused_pair_fwd(prep, *x, flags=flags)


@BANDS
@CASES
def test_restricted_forward_plain_is_exact(seed, step, env_band):
    """The plain forward restricted to the tiles `cull_tiles` keeps gives
    the same cov, E_pair, env, planes and vcov, bit for bit; dropping a
    kept tile with a live pair changes them."""
    prep, x = kc.fused_case(seed, env_band, step, CPU)
    keep = fp.cull_tiles(prep, x[0], x[2])
    full = fp.fused_pair_fwd_plain(prep, *x)
    cut = fp.fused_pair_fwd_plain(prep, *x, keep=keep)
    assert all(torch.equal(a, b) for a, b in zip(full, cut))
    assert full[0].abs().max() > 0 or full[1].abs().max() > 0
    if env_band:
        assert full[2].abs().max() > 0
    lk = tc.pair_keep(keep, prep.n1, prep.n2) & fp.live_pairs(prep, x[0],
                                                              x[2])
    b, i, j = (int(v[0]) for v in torch.nonzero(lk, as_tuple=True))
    fewer = keep.clone()
    fewer[b, i // 32, j // 32] = False
    less = fp.fused_pair_fwd_plain(prep, *x, keep=fewer)
    assert not all(torch.equal(a, b) for a, b in zip(less, full))
