"""Share of the traced training window in which no kernel or memset ran on
the device (`trace.Traced`: 1 - busy / window, busy the union of their
intervals), over whole optimiser steps."""

UNIT = "fraction"


def read(traced):
    return traced.idle_share
