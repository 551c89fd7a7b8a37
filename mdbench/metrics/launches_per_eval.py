"""Device launches (kernels and memsets) in the traced window over the
force evaluations in it: the graph's launch count (`system.py`,
`nodes/*`), which the host pays for on every evaluation."""

UNIT = "launches"


def read(traced):
    return traced.launches / traced.evals
