"""Host time blocked in reads of device data an optimiser step, in ms: the
host time of the program's `sync.*` spans (the loss's read, the tables'
round trip to the host when the fused block rebuilds its operands) over
the window's `train.step` spans (`upside_md_torch/tracing.py`).  Nothing
to read where the program has no recorder or no host sync ran."""

UNIT = "ms"


def read(traced):
    try:
        from upside_md_torch import tracing
    except ImportError:
        return None
    w = tracing.last_window()
    if w is None or not any(n.startswith("sync.") for n in w.spans):
        return None
    if w.steps != traced.evals:
        raise RuntimeError(f"the recorder counted {w.steps} steps, the "
                           f"traced window {traced.evals}")
    return 1e3 * w.total(("sync.",), "host") / w.steps
