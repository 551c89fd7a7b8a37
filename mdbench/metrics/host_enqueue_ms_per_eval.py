"""Host time of the MD driver a force evaluation, in ms: the host time of
the program's `md.round` spans less the `sync.*` spans inside them (the
host waiting on the device), over the window's evaluations: what the
host spends issuing an evaluation's launches (`upside_md_torch/
tracing.py`).  Nothing to read where the program has no recorder or no
round span ran."""

UNIT = "ms"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or "md.round" not in w.spans:
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    host = w.total(("md.round",), "host") - w.inside(
        ("md.round",), ("sync.",), "host")
    return 1e3 * host / w.evals
