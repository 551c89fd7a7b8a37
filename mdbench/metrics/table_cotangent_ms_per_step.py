"""Device time of the table cotangents an optimiser step, in ms: the
stream time of the program's `cotangent.*` spans (`cotangent.table`,
`cotangent.env_table`, `cotangent.identity_edge`) over the window's
`train.step` spans (`upside_md_torch/tracing.py`).  Nothing to read where
the program has no recorder or no cotangent span ran."""

UNIT = "ms"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or not any(n.startswith("cotangent.") for n in w.spans):
        return None
    if w.steps != traced.evals:
        raise RuntimeError(f"the recorder counted {w.steps} steps, the "
                           f"traced window {traced.evals}")
    return 1e3 * w.total(("cotangent.",)) / w.steps
