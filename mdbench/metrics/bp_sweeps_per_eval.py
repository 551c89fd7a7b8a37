"""BP sweeps a force evaluation: the program's counter
`SimState.bp_sweeps`, summed over the replicas, over the replicas and the
state's `n_evals`, over the whole window."""

UNIT = "sweeps"


def read(traced):
    return traced.counters["bp_sweeps_per_eval"]
