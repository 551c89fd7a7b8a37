"""Device time of the plain PyTorch nodes a force evaluation, in ms: the
stream time of the program's `node.*` and `fused_pair*` spans (each
node's forward and backward, the fused block's), less the `kernel.*` and
`bp.*` spans directly inside them, over the window's evaluations
(`upside_md_torch/tracing.py`).  Stream time runs between a span's two
CUDA events: busy time and any idle inside the span.  Nothing to read
where the program has no recorder or no node span ran."""

UNIT = "ms"
NODES = ("node.", "fused_pair")


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or not any(n.startswith(NODES) for n in w.spans):
        return None
    if w.evals != traced.evals:
        raise RuntimeError(f"the recorder counted {w.evals} evaluations, "
                           f"the traced window {traced.evals}")
    stream = w.total(NODES) - w.inside(NODES, ("kernel.", "bp."),
                                       direct=True)
    return 1e3 * stream / w.evals
