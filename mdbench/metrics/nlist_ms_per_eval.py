"""Device time of the fixed-K neighbour lists a force evaluation, in ms:
the stream time of the program's `nlist.<site>` spans (each list's whole
forward: its build, the row gather, the pair spline on the list and the
scatter back; the sites `rotamer`, the coverage nodes' names and
`radial`) and of their backward spans `nlist.<site>.bwd`, over the
window's evaluations (`upside_md_torch/tracing.py`).  The `nlist.build`
spans nested inside the forward ones are not added again.  Stream time
runs between a span's two CUDA events: busy time and any idle inside the
span.  Nothing to read where the program has no recorder or no list span
ran (at most 1,024 beads and columns)."""

UNIT = "ms"
NESTED = "nlist.build"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    spans = [] if w is None else [s for n, s in w.spans.items()
                                  if n.startswith("nlist.") and n != NESTED]
    if not spans:
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    return 1e3 * sum(s.time() for s in spans) / w.evals
