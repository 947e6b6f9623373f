"""Checkpointing (``nf_tpu/utils/serialization.py``; the reference only
offers ``torch.save(state_dict)`` of a model's weights, ``core.py:
199-213``).

* :func:`save` / :func:`load`: a model's ``state_dict`` as one ``.npz``,
  loaded into a template model of the same structure (bfloat16 is stored
  as float32 and cast back to the template's dtype; shapes are checked).
* :class:`CheckpointManager`: the whole training state per step (model,
  optimizer, EMA, step count and a generator's state), each step a
  directory written under a temporary name and renamed into place, so an
  interrupted write leaves the last complete step the latest. The JAX
  package writes with orbax; the port's files are ``torch.save``'s, read
  back with ``weights_only=True``. A restore copies into the state's
  tensors in place, so a CUDA graph captured on them (a captured training
  step) replays on the restored values. ``save(..., wait=False)`` returns
  once the state is copied to the host and writes on one worker thread,
  as the JAX package's orbax saves overlap the next steps
  (:meth:`CheckpointManager.wait_until_finished`).
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d+)$")


def save(path, model):
    """Write every tensor of ``model.state_dict()`` to the ``.npz``
    ``path``, under its state-dict name."""
    arrays = {}
    for name, t in model.state_dict().items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            # npz has no bfloat16; load() casts back to the template's dtype
            t = t.to(torch.float32)
        arrays[name] = t.cpu().numpy()
    np.savez(path, **arrays)


def load(path, template):
    """Copy the arrays of the ``.npz`` ``path`` into ``template`` in place
    and return it. Each is cast to the template tensor's dtype, so a file
    saved at another precision makes no mixed-precision model; a tensor
    the file lacks keeps the template's value, and a shape that differs
    raises ``ValueError``."""
    own = template.state_dict()
    new = {}
    with np.load(path, allow_pickle=False) as data:
        for name, t in own.items():
            if name not in data:
                new[name] = t
                continue
            arr = torch.from_numpy(np.array(data[name])).to(t.dtype)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} in "
                                 f"{path}, {tuple(t.shape)} in the template")
            new[name] = arr
    template.load_state_dict(new)
    return template


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _same_layout(optimizer, saved):
    """Whether ``saved`` (a state dict of ``optimizer``'s kind) has state
    for exactly the parameters that have it now, key for key and shape
    for shape."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    now = {i: optimizer.state[p] for i, p in enumerate(params)
           if p in optimizer.state}
    if set(now) != set(saved["state"]):
        return False
    for i, st in now.items():
        old = saved["state"][i]
        if set(st) != set(old):
            return False
        for k, v in st.items():
            if torch.is_tensor(v) and (not torch.is_tensor(old[k])
                                       or v.shape != old[k].shape):
                return False
    return len(saved["param_groups"]) == len(optimizer.param_groups)


def _load_optimizer(optimizer, saved):
    """``optimizer.load_state_dict(saved)``, but into the tensors it holds
    where it has them: a captured step updates those at their addresses
    and refuses new ones."""
    if not _same_layout(optimizer, saved):
        optimizer.load_state_dict(saved)
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        for i, p in enumerate(params):
            for k, v in optimizer.state.get(p, {}).items():
                old = saved["state"][i][k]
                if torch.is_tensor(v):
                    v.copy_(old)
                else:
                    optimizer.state[p][k] = old
        for group, old in zip(optimizer.param_groups,
                              saved["param_groups"]):
            for k, v in old.items():
                if k == "params":
                    continue
                if torch.is_tensor(group.get(k)):
                    group[k].copy_(v)
                elif group.get(k) != v:
                    group[k] = v


class CheckpointManager:
    """Training-state checkpoints in ``directory``, one ``step_<n>/``
    each, the newest ``max_to_keep`` kept."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        # one writer, so pending writes land in the order of their saves
        self._writer = None
        self._pending = []
        os.makedirs(self.directory, exist_ok=True)
        # a write that was cut left its temporary directory behind
        for name in os.listdir(self.directory):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _dir(self, step):
        return os.path.join(self.directory, f"step_{int(step)}")

    def all_steps(self):
        """The steps with a complete checkpoint, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 _STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self):
        """The newest complete step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, generator=None, wait=True):
        """Write ``state`` (a ``parallel.TrainState``) and, when given,
        ``generator``'s state as checkpoint ``step``; the oldest steps
        beyond ``max_to_keep`` are removed. Reads the device once, to copy
        the tensors to the host: that copy is synchronous, so a captured
        step replayed next, which rewrites the tensors in place, cannot
        change what is written. ``wait=False`` returns after the copy and
        leaves the write to the worker thread
        (:meth:`wait_until_finished`); a write's error is raised by the
        next ``save``, ``restore`` or ``wait_until_finished``."""
        payload = _to_cpu({
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": None if state.ema is None else state.ema.state_dict(),
            "generator": None if generator is None
            else generator.get_state()})
        if wait:
            self.wait_until_finished()
            self._write(step, payload)
            return
        self._reap()
        if self._writer is None:
            self._writer = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._pending.append(self._writer.submit(self._write, step, payload))

    def _write(self, step, payload):
        tmp = os.path.join(self.directory, f".tmp_step_{int(step)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        final = self._dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir(old))

    def _reap(self):
        """Drop the finished writes, raising the first one's error."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def wait_until_finished(self):
        """Block until every pending write is on disk (``orbax``'s
        ``wait_until_finished``); raises a failed write's error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def restore(self, state, step=None, generator=None):
        """Load checkpoint ``step`` (None: the latest) into ``state`` and
        ``generator`` in place; returns ``(state, step)``, or ``(None,
        None)`` when there is no checkpoint. The parameters, buffers and
        the optimizer's state tensors keep their addresses when their
        layout matches (a captured step goes on replaying on them).
        Waits for the pending writes first."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        payload = torch.load(os.path.join(self._dir(step), _STATE_FILE),
                             map_location="cpu", weights_only=True)
        with torch.no_grad():
            state.model.load_state_dict(payload["model"])
            if state.ema is not None and payload["ema"] is not None:
                state.ema.load_state_dict(payload["ema"])
        _load_optimizer(state.optimizer, payload["optimizer"])
        if generator is not None:
            if payload["generator"] is None:
                raise ValueError(f"checkpoint {step} holds no generator "
                                 f"state")
            generator.set_state(payload["generator"])
        state.step = payload["step"]
        return state, step
