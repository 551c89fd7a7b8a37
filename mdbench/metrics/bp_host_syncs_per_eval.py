"""Host synchronisations of the plain BP solve a force evaluation: the
program's counter `ops/bp_pairs.HOST_SYNCS["bp_solve_plain"]` over the
window's evaluations.  Nothing to read where the plain solve never ran."""

UNIT = "syncs"


def read(traced):
    value = traced.counters["bp_host_syncs_per_eval"]
    return value if value > 0 else None
