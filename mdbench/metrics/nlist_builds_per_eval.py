"""Fixed-K neighbour lists built a force evaluation: the change of the
program's counters `nlist.<site>` over the traced window
(`upside_md_torch/tracing.py`, one count a list built), over the
window's evaluations.  One a list an evaluation while every evaluation
builds its lists anew (GFP: the rotamer grid and both coverages, 3);
fewer where lists are reused.  Nothing to read where the program has no
recorder or built no list."""

UNIT = "lists"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None:
        return None
    built = sum(n for k, n in w.counters.items() if k.startswith("nlist."))
    if not built:
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    return built / w.evals
