"""`ops/pairs.gather_rows`, the neighbour lists' row gather whose backward
sums in a fixed order (`gather_rows_bwd`, csrc/gather_rows.cu; its plain
version on the CPU).

* The forward equals `index_select` over the flattened replicas bit for
  bit, under a mask that keeps every slot and under one that does not.
* The gradient equals `index_add`'s (what `index_select`'s backward
  computes) within rel 1e-6 in float32, and a second call gives it bit
  for bit; slots off the mask take no cotangent.
* Past the 1,024-column threshold of the nodes (1,100 columns, 48 rows,
  the coverages' width K = 96), `quadspline_coverage_nl` on the dense
  grid and its position and direction gradients equal the JAX package's
  (upside_md_tpu/ops/pairs.py:82-131) within atol 1e-8 in float64, as
  tests/test_torch_pairs_nl.py holds them.
* On the card (`requires_cuda`, skipped without one): the kernel against
  the plain version at the coverages' shapes, rel 1e-6, and bitwise equal
  on a second launch; with `plain` the wrapper takes the plain version on
  the card, float64 included, and launches nothing.  JAX is imported only by the test that compares
  with it, so that `python -m pytest --noconftest -m requires_cuda
  tests/test_torch_gather_rows.py` runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401
from upside_md_torch.ops import pairs

B, N, W, N1, K = 3, 50, 6, 40, 16


def _case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(B, N, W)), dtype=dtype)
    idx = torch.tensor(rng.integers(0, N, (B, N1, K)))
    mask = torch.tensor(rng.random((B, N1, K)) < 0.7)
    g = torch.tensor(rng.normal(size=(B, N1, K, W)), dtype=dtype)
    return x, idx, mask, g


@pytest.mark.parametrize("masked", [False, True])
def test_forward_equals_index_select(masked):
    x, idx, mask, _ = _case(torch.float32)
    got = pairs.gather_rows(x, idx, mask if masked else
                            torch.ones_like(mask))
    want = x.reshape(B * N, W).index_select(0, pairs.flat_rows(idx, N))
    assert torch.equal(got, want.reshape(B, N1, K, W))


def _grad(x, idx, mask, g):
    leaf = x.clone().requires_grad_(True)
    (out,) = torch.autograd.grad((pairs.gather_rows(leaf, idx, mask) * g)
                                 .sum(), leaf)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_gradient_equals_index_add_and_repeats(masked):
    x, idx, mask, g = _case(torch.float32, seed=1)
    m = mask if masked else torch.ones_like(mask)
    if masked:
        g = torch.where(mask[..., None], g, torch.zeros_like(g))
    got = _grad(x, idx, m, g)
    want = torch.zeros(B * N, W).index_add_(0, pairs.flat_rows(idx, N),
                                            g.reshape(-1, W))
    rel = ((got.reshape(B * N, W) - want).abs().max()
           / want.abs().max()).item()
    assert rel <= 1e-6
    assert torch.equal(got, _grad(x, idx, m, g))


def test_off_mask_slots_take_no_cotangent():
    x, idx, mask, g = _case(torch.float64, seed=2)
    got = _grad(x, idx, mask, g)
    kept = torch.where(mask[..., None], g, torch.zeros_like(g))
    assert torch.equal(got, _grad(x, idx, torch.ones_like(mask), kept))


def test_row_segments_are_in_slot_order():
    flat = torch.tensor([3, 1, 3, 0, 1, 3, 2])
    mask = torch.tensor([True, True, False, True, True, True, True])
    order, starts = pairs.row_segments(flat, 5, mask)
    assert starts.tolist() == [0, 1, 3, 4, 6, 6]
    assert order[:6].tolist() == [3, 1, 4, 6, 0, 5]


def test_coverage_nl_past_the_threshold_matches_jax():
    import jax
    import jax.numpy as jnp

    from upside_md_tpu.ops import pairs as jpairs
    rng = np.random.default_rng(17)
    n1, n2, ka, k, width = 48, 1100, 8, 9, 96

    def unit(shape):
        d = rng.normal(size=shape)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    table = rng.normal(size=(3, 3, 2 * ka + 2 * k))
    t1, t2 = rng.integers(0, 3, n1), rng.integers(0, 3, n2)
    sites = [6.0 * rng.normal(size=(1, n1, 3)), unit((1, n1, 3)),
             6.0 * rng.normal(size=(1, n2, 3)), unit((1, n2, 3))]
    base = np.abs(np.arange(n1)[:, None] - np.arange(n2)[None, :]) > 2
    g = rng.normal(size=(n1, n2))

    leaves = [torch.tensor(s, requires_grad=True) for s in sites]
    cov, idx, mask = pairs.quadspline_coverage_nl(
        torch.tensor(table), torch.tensor(t1), torch.tensor(t2), *leaves,
        ka, k, 1.0, torch.tensor(base), width)
    assert not mask.all() and mask.any()
    dense = pairs.scatter_rows(cov, idx, mask, n2)
    got = torch.autograd.grad((dense[0] * torch.tensor(g)).sum(), leaves)

    def grid(*s):
        c, i, m = jpairs.quadspline_coverage_nl(
            jnp.asarray(table), t1, t2, *s, ka, k, 1.0, jnp.asarray(base),
            width)
        return jpairs.scatter_rows(c, i, m, n2)

    args = [jnp.asarray(s[0]) for s in sites]
    want = jax.jit(grid)(*args)
    np.testing.assert_allclose(dense[0].detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-8)
    grads = jax.jit(jax.grad(lambda *s: jnp.sum(grid(*s) * g),
                             argnums=(0, 1, 2, 3)))(*args)
    for g_t, g_j in zip(got, grads):
        np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j), rtol=0,
                                   atol=1e-8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
def test_kernel_equals_plain_on_the_card(cuda):
    rng = np.random.default_rng(5)
    b, n, n1, width = 4, 1143, 470, 96
    idx = torch.tensor(rng.integers(0, n, (b, n1, width)), device=cuda)
    mask = torch.tensor(rng.random((b, n1, width)) < 0.6, device=cuda)
    g = torch.tensor(rng.normal(size=(b * n1 * width, W)),
                     dtype=torch.float32, device=cuda)
    order, starts = pairs.row_segments(pairs.flat_rows(idx, n), b * n, mask)
    got = pairs.gather_rows_bwd(g, order, starts)
    again = pairs.gather_rows_bwd(g, order, starts)
    want = pairs.gather_rows_bwd_plain(g, order, starts)
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-6
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
def test_plain_on_the_card_launches_nothing(cuda):
    from upside_md_torch.ops import kernels
    x, idx, mask, g = (t.to(cuda) for t in _case(torch.float64, seed=3))
    before = kernels.LAUNCHES.get("gather_rows_bwd", 0)
    leaf = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        (pairs.gather_rows(leaf, idx, mask, plain=True) * g).sum(), leaf)
    assert kernels.LAUNCHES.get("gather_rows_bwd", 0) == before
    assert torch.equal(got.cpu(), _grad(*(t.cpu() for t in (x, idx, mask,
                                                             g))))
