"""Share of the traced MD window in which no kernel or memset ran on the
device (`trace.Traced`: 1 - busy / window, busy the union of their
intervals), over whole chunks of rounds."""

UNIT = "fraction"


def read(traced):
    return traced.idle_share
