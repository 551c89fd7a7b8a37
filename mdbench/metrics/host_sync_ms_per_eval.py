"""Host time blocked in reads of device data a force evaluation, in ms:
the host time of the program's `sync.*` spans (the plain BP solve's
convergence test, `sync.bp_solve_plain`) over the window's evaluations
(`upside_md_torch/tracing.py`).  Nothing to read where the program has no
recorder or no host sync ran."""

UNIT = "ms"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or not any(n.startswith("sync.") for n in w.spans):
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    return 1e3 * w.total(("sync.",), "host") / w.evals
