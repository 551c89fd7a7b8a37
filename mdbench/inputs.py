"""The inputs a run makes from its seed, on the device: initial momenta,
thermostat noise and the training ensemble.  The same seed gives the same
inputs; the reference regenerates what it needs from the same calls."""

from __future__ import annotations

import torch

from .harness import mix_seed


def _generator(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def momenta(seed, shape, temperature, device):
    """Maxwell-Boltzmann momenta sqrt(T) N(0, 1) (unit masses)."""
    g = _generator(device, mix_seed(seed, "momenta"))
    return temperature ** 0.5 * torch.randn(shape, generator=g,
                                            device=device)


class Noise:
    """Thermostat noise of round `nr`: N(0, 1) of the replicas' momentum
    shape, drawn from its own stream, so any subset of rounds can be drawn
    again in any order."""

    def __init__(self, seed, shape, device):
        self.seed, self.shape, self.device = seed, tuple(shape), device
        self.gen = torch.Generator(device=device)

    def __call__(self, nr):
        self.gen.manual_seed(mix_seed(self.seed, "noise", int(nr)))
        return torch.randn(self.shape, generator=self.gen,
                           device=self.device)


def ensemble(seed, path, n, device, dtype):
    """n configurations (n, n_atom, 3): distinct frames of the pool in the
    .npy file at `path` (`make_frames.py`), which and in what order drawn
    from the seed."""
    import numpy as np
    pool = np.load(path)
    g = torch.Generator()
    g.manual_seed(mix_seed(seed, "ensemble"))
    rows = torch.randperm(len(pool), generator=g)[:n].numpy()
    return torch.as_tensor(pool[rows], dtype=dtype, device=device)


def sample(seed, n, k):
    """k distinct indices of range(n), drawn from the seed (sorted)."""
    g = torch.Generator()
    g.manual_seed(mix_seed(seed, "sample"))
    return torch.randperm(n, generator=g)[:k].sort().values
