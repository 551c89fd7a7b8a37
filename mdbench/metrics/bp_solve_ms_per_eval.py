"""Device time of BP a force evaluation, in ms: the stream time of the
program's `bp.*` spans (K2 `bp.k2`, K6 `bp.k6`, the plain solve
`bp.plain`, their backward `bp.bwd`) over the window's evaluations
(`upside_md_torch/tracing.py`).  Nothing to read where the program has no
recorder or no BP span ran."""

UNIT = "ms"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or not any(n.startswith("bp.") for n in w.spans):
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    return 1e3 * w.total(("bp.",)) / w.evals
