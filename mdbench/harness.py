"""What every cell of the benchmark shares: finding a cell's files by name,
seeds, the device record, the result line and the import guard.

A cell is `workloads/<name>.json`; it names its configuration
(`configs/<config>.json`), its mode (`modes/<mode>.py`, a module with a
`Run` class), any pool of frames it draws from (`frames/<frames>.npy`) and
its per-layer metrics (`metrics/<metric>.py`, a module
with `read(traced)`).  Adding any of them is adding a file.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level modules that must not be loaded in a run: JAX and the JAX
# package the program was ported from (compared by whole top-level name:
# the program's own package name begins with the same letters)
FORBIDDEN = ("jax", "jaxlib", "flax", "upside_md_tpu")


def load_json(kind, name):
    path = os.path.join(BENCH, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_workload(name):
    """The cell's workload file with its configuration under `config`."""
    wl = load_json("workloads", name)
    wl["name"] = name
    wl["config"] = dict(load_json("configs", wl["config"]),
                        name=wl["config"])
    if "frames" in wl:
        wl["frames_file"] = os.path.join(BENCH, "frames",
                                         wl["frames"] + ".npy")
    return wl


def load_module(kind, name):
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"mdbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bundle_path(config):
    """The configuration's bundle, a file of the program's data folder."""
    return os.path.join(ROOT, "upside_md_torch", "data",
                        config["bundle"] + ".npz")


def mix_seed(seed, *keys):
    """A 63-bit seed for one stream of inputs, from the run's seed and the
    stream's name: any whole number gives every stream its own."""
    h = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_record(device, count=1):
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def read_metrics(workload, traced, result):
    """The cell's per-layer metrics from a traced window, each by its own
    reader (a reader that finds nothing returns None, and the metric is
    left out), and the device's busy and window seconds."""
    for name in workload["per_layer"]:
        reader = load_module("metrics", name)
        value = reader.read(traced)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": reader.UNIT}
    result["device"]["busy_s"] = traced.busy_s
    result["device"]["window_s"] = traced.window_s
    result["breakdown"] = traced.breakdown
    print(f"card (name, power limit): {power_limit()}", file=sys.stderr)


def judge(readings, limits):
    """(correct, checks): each number compared beside its limit; a number
    that is not finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = float(readings[name])
        checks[name] = {"value": value, "limit": float(limit)}
        if not value <= limit:
            correct = False
    return correct, checks


def report(result, out=None, err=None):
    """Print the checks as the last lines on standard error and the result
    as the last line on standard output, the checks under their own key,
    last."""
    out, err = out or sys.stdout, err or sys.stderr
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=err, flush=True)
    result["checks"] = checks
    print(json.dumps(result), file=out, flush=True)
