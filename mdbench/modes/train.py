"""Training cells: contrastive-divergence fitting of force-field tables by
the program's `training.fit` with Adam, as a force-field developer runs it.

Set-up builds the program's `System` from the configuration's bundle,
loads its kernels' library, takes the native structure (the bundle's) and
draws the ensemble from the seed: `ensemble` distinct frames of the cell's
pool of MD frames (`frames/<frames>.npy`, made by `make_frames.py`).  A
first `fit` of `warmup_steps` steps warms up every shape on copies of the
tables (`fit` trains copies).  The window is a second `fit` from the
bundle's tables, its steps until `--seconds` have passed; a callback reads,
as the optimiser gets them, the window's first step's gradient and the
tables after its first `check_steps` steps, and closes the window.

After the window the program is freed and the reference follows the
checked steps from the bundle's tables (`reference/train.py`):
`compare.train_gaps` measures each step's loss, the first gradient and the
tables' change against it.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from mdbench import compare, harness, inputs
from mdbench.reference import train as ref_train
from mdbench.reference.forcefield import ForceField, load_bundle
from mdbench.trace import Traced


class WindowClosed(Exception):
    """Raised by the callback to end `fit` when the window has passed."""


class Run:
    def __init__(self, workload, device, seed):
        self.wl, self.device, self.seed = workload, torch.device(device), seed

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _program(self):
        from upside_md_torch import training
        from upside_md_torch.ops import kernels
        from upside_md_torch.system import System
        wl = self.wl
        system, pos0 = System.from_bundle(harness.bundle_path(wl["config"]),
                                          self.device)
        if self.device.type == "cuda":
            kernels.library()
        ens = inputs.ensemble(self.seed, wl["frames_file"], wl["ensemble"],
                              self.device, pos0.dtype)
        loss = self.loss(training, system, pos0, ens)
        trainable, frozen = training.select_trainable(system.params,
                                                      wl["tables"])
        return training, loss, trainable, frozen, pos0, ens

    def loss(self, training, system, pos0, ens):
        """The loss the window fits (a calibration plants faults here)."""
        return training.contrastive_divergence_loss(
            system, pos0, ens, self.wl["temperature"])

    def execute(self, seconds, trace, t_start):
        wl = self.wl
        training, loss, trainable, frozen, pos0, ens = self._program()
        n_check = wl["check_steps"]
        rec = {"losses": [], "steps": 0, "prof": None, "ends": []}
        traced_to = n_check + wl["trace_steps"]
        start = {n: {k: v.detach().clone() for k, v in p.items()}
                 for n, p in trainable.items()}
        training.fit(loss, trainable, frozen, n_steps=wl["warmup_steps"],
                     learning_rate=wl["learning_rate"])

        def callback(i, leaves, value):
            step = rec["steps"] = i + 1
            rec["ends"].append(time.perf_counter())
            if step <= n_check:
                rec["losses"].append(value)
            if step == 1:
                rec["grad"] = compare.leaf_norms(
                    {n: p["interaction_param"].grad for n, p in leaves.items()})
            if step == n_check:
                rec["change"] = compare.leaf_norms(
                    {n: p["interaction_param"].detach()
                     - start[n]["interaction_param"]
                     for n, p in leaves.items()})
                if trace:
                    self._sync()
                    rec["prof"] = _profiler()
                    rec["prof"].start()
            if trace and step == traced_to:
                self._sync()
                rec["prof"].stop()
            if step >= n_check and time.perf_counter() - t0 >= seconds and (
                    not trace or step >= traced_to):
                raise WindowClosed

        self._sync()
        t0 = time.perf_counter()
        try:
            training.fit(loss, trainable, frozen, n_steps=2 ** 62,
                         learning_rate=wl["learning_rate"], callback=callback)
        except WindowClosed:
            pass
        self._sync()
        window = time.perf_counter() - t0
        setup_s = t0 - t_start
        steps_s = [round(b - a, 4) for a, b in zip([t0] + rec["ends"],
                                                    rec["ends"])]
        traced = f" (steps {n_check + 1}-{traced_to} traced)" if trace else ""
        print(f"window's step seconds{traced}: {steps_s}", file=sys.stderr)
        result = {"metrics": {}, "attempted": rec["steps"],
                  "device": harness.device_record(self.device)}
        ens, pos0 = ens.cpu(), pos0.cpu()
        prof = rec.pop("prof")
        del training, loss, trainable, frozen
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if trace:
            harness.read_metrics(wl, Traced(prof, wl["trace_steps"]), result)
        else:
            result["metrics"]["train_step_ms"] = {
                "value": 1e3 * window / rec["steps"], "unit": "ms"}
            result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        del prof
        readings = self.check(rec, pos0, ens)
        result["correct"], result["checks"] = harness.judge(readings,
                                                            wl["limits"])
        result["failed"] = 0 if result["correct"] else 1
        return result

    def reference(self, pos0, ens, dtype=torch.float64):
        """The reference's (losses, first gradient norms, change norms)."""
        wl = self.wl
        nodes, _ = load_bundle(harness.bundle_path(wl["config"]))
        ff = ForceField(nodes, self.device, dtype)
        losses, grad, change = ref_train.follow(
            ff, wl["tables"], pos0.to(self.device, dtype),
            ens.to(self.device, dtype), wl["check_steps"],
            wl["learning_rate"], temperature=wl["temperature"], block=64)
        return losses, compare.leaf_norms(grad), compare.leaf_norms(change)

    def check(self, rec, pos0, ens):
        self.window = (pos0, ens, self.reference(pos0, ens))
        return compare.train_gaps(rec["losses"], rec["grad"], rec["change"],
                                  *self.window[2])

    def control(self, dtype=torch.bfloat16):
        """The readings of the reference computed in `dtype` in the
        program's place, on the last window's inputs."""
        pos0, ens, ref = self.window
        return compare.train_gaps(*self.reference(pos0, ens, dtype), *ref)


def _profiler():
    # device activity and the CUDA runtime's calls alone: recording every
    # host operator as well slows the host's enqueue of a step
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])
