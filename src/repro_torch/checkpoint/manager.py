"""Checkpoints of the port's tensor trees: atomic npz files and JSON
metadata; the port of ``repro.checkpoint.manager``.

* every leaf is saved under its ``"/"``-joined key path (the reference's
  ``_flatten`` layout: ``params/seg0/c0/attn/wq``, ``opt/m/...``,
  ``opt/step``), so a float32 checkpoint written by either package
  restores into the other;
* a bfloat16 leaf is stored as float32, which holds it exactly (numpy has
  no bfloat16), and ``restore`` casts it back to the template's dtype;
  other leaves keep their dtype;
* writes go to ``<dir>/tmp.<step>`` and are then renamed to
  ``step_<8 digits>`` (atomic on POSIX): a killed job never leaves a half
  checkpoint visible;
* ``keep_last`` garbage-collects old steps after a successful commit;
* ``async_save`` copies the state to host memory before ``save`` returns
  (the train step updates parameters in place) and writes it from a
  thread, so the train loop goes on at once; ``wait`` joins the writer.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a tensor that training will
    update in place); bfloat16 becomes float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten(state: dict) -> dict[str, np.ndarray]:
    return {"/".join(path): _to_host(t) for path, t in flatten(state)}


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: dict, meta: Optional[dict] = None) -> str:
        """Write ``state`` (a tree of tensors) as checkpoint ``step``;
        returns its final path (written once ``wait`` returns, with
        ``async_save``)."""
        flat = _flatten(state)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_async, args=(step, flat, meta or {}),
                daemon=True)
            self._thread.start()
            return self._final_path(step)
        return self._write(step, flat, meta or {})

    def _final_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, flat: dict, meta: dict) -> str:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = self._final_path(step)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)              # atomic commit
        self._gc()
        return final

    def _write_async(self, step: int, flat: dict, meta: dict) -> None:
        try:
            self._write(step, flat, meta)
        except Exception as exc:            # re-raised by wait()
            self._error = exc

    def wait(self) -> None:
        """Join the writer of the last ``async_save``; raise what it
        raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self._final_path(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: Optional[int] = None) -> tuple:
        """(state, meta) of checkpoint ``step`` (the latest when None),
        restored into the structure of ``template``: each leaf must have
        the template leaf's shape and takes its dtype and device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._final_path(step)
        with np.load(os.path.join(path, "state.npz")) as z:
            flat = {k: z[k] for k in z.files}
        leaves = []
        for key_path, leaf in flatten(template):
            key = "/".join(key_path)
            if key not in flat:
                raise KeyError(f"checkpoint step {step} has no leaf {key}")
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template shape {tuple(leaf.shape)}")
            leaves.append((key_path, torch.from_numpy(arr).to(
                device=leaf.device, dtype=leaf.dtype)))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return unflatten(leaves), meta
