"""Ornstein-Uhlenbeck thermostat (port of upside_md_tpu/md/thermostat.py;
reference src/thermostat.{h,cpp}):

    mom' = exp(-dt/tau) mom + sqrt(T (1 - exp(-2 dt/tau))) N(0, 1)

The noise comes from an explicit `torch.Generator`, or is handed in (the
parity tests feed both frameworks the same numbers)."""

from __future__ import annotations

import math

import torch


class OUThermostat:
    def __init__(self, timescale, delta_t):
        self.timescale = timescale
        self.delta_t = delta_t

    @property
    def mom_scale(self):
        return math.exp(-self.delta_t / self.timescale)

    def apply(self, mom, temperature, generator=None, noise=None):
        """temperature: scalar or (B,) per replica."""
        if noise is None:
            noise = torch.randn(mom.shape, generator=generator,
                                dtype=mom.dtype, device=mom.device)
        temp = torch.as_tensor(temperature, dtype=mom.dtype,
                               device=mom.device)
        temp = temp.reshape(temp.shape + (1,) * (mom.ndim - temp.ndim))
        s = self.mom_scale
        return s * mom + torch.sqrt(temp * (1.0 - s * s)) * noise


def thermalize(shape, temperature, generator=None, dtype=torch.float32,
               device="cuda"):
    """Maxwell-Boltzmann momenta: sqrt(T) N(0, 1), on the card unless
    `device` says otherwise (as `System`); `generator` must live on that
    device."""
    noise = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
    temp = torch.as_tensor(temperature, dtype=dtype, device=device)
    temp = temp.reshape(temp.shape + (1,) * (len(shape) - temp.ndim))
    return torch.sqrt(temp) * noise
