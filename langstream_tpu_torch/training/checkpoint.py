"""Checkpoint / resume for model weights and trainer state.

Port of ``langstream_tpu/training/checkpoint.py`` without orbax: the same
``<dir>/<step>/`` layout and the same manager rules, in files the port
writes and reads itself (the card's machine has no ``safetensors`` or
orbax package).

A step directory holds:

- ``params/model.safetensors``: the parameters by name;
- ``opt_state/model.safetensors``: the optimizer state's tensors, each
  named by its path in the state's nested dict (``mu/wq``);
- ``checkpoint.json``: the format's name, the step, and the state's
  scalars by path (AdamW's ``count``);
- ``meta.json``: the caller's meta (the trainer writes ``model_config``).

Rules, as the installed orbax ``CheckpointManager`` applies them:

- ``save`` returns False and writes nothing when the step is not past
  the latest one, or when it is off ``save_interval_steps`` and a step
  exists already (the first save is always taken);
- ``max_to_keep`` keeps the newest steps and deletes the others once the
  new step is committed;
- a step is written under a temporary name (``<step>.tmp-<hex>``) and
  renamed into place: a directory scan (a fresh manager, the provider)
  never sees a half-written step;
- ``save`` copies every tensor to host memory before it returns, so the
  caller may update its tensors in place at once; the files are written
  on a background thread, which ``wait`` joins (orbax: a blocking
  device-to-host copy, then an asynchronous commit). ``all_steps`` and
  ``latest_step`` count a queued step, as orbax's do; ``restore`` waits
  for it.

:func:`config_meta` keeps the rope-scaling tuple (as a list), which the
JAX package's drops: a Llama-3.2 config restores with its scaling.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.providers.torch_local.weights import SafetensorsDir, write_safetensors

FORMAT = "langstream_tpu_torch"
STATE_FILE = "checkpoint.json"
META_FILE = "meta.json"
TENSOR_FILE = "model.safetensors"
TMP_MARK = ".tmp-"


def is_step_dir(path: str) -> bool:
    """Whether ``path`` is a step directory this module wrote."""
    try:
        with open(os.path.join(path, STATE_FILE)) as fh:
            return json.load(fh).get("format") == FORMAT
    except (OSError, ValueError):
        return False


def committed_steps(directory: str) -> List[int]:
    """The steps under ``directory``, ascending: numeric directory names
    only, so a temporary name is never one."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(entry) for entry in os.listdir(directory)
                  if entry.isdigit() and os.path.isdir(os.path.join(directory, entry)))


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A nested dict → (tensors by path, scalars by path), paths joined
    with ``/``."""
    tensors, scalars = {}, {}
    for key, value in tree.items():
        path = prefix + key
        if isinstance(value, dict):
            sub_tensors, sub_scalars = _flatten(value, path + "/")
            tensors.update(sub_tensors)
            scalars.update(sub_scalars)
        elif isinstance(value, torch.Tensor):
            tensors[path] = value
        elif isinstance(value, (bool, int, float)):
            scalars[path] = value
        else:
            raise TypeError(f"{path}: cannot checkpoint a {type(value).__name__}")
    return tensors, scalars


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _host_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every tensor copied into fresh host memory (a CPU tensor too)."""
    return {name: tensor.detach().to("cpu", copy=True) for name, tensor in tensors.items()}


def _read_tensors(path: str) -> Dict[str, torch.Tensor]:
    store = SafetensorsDir(path)
    try:
        return {name: store.get(name) for name in store.keys()}
    finally:
        store.close()


class CheckpointManager:
    """(params, opt_state, step, meta) under ``directory``, one step
    directory each; see the module's docstring for the rules."""

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: Optional[int] = 3,
        save_interval_steps: int = 1,
    ) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._steps = committed_steps(self.directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(
        self,
        step: int,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Copy the state to the host and queue its write; returns
        whether a save was started. One save is in flight at a time: a
        second waits for the first."""
        if not self.should_save(step):
            return False
        self.wait()
        opt_tensors, scalars = _flatten(opt_state) if opt_state is not None else ({}, None)
        snapshot = {"params": _host_copy(params), "opt_state": _host_copy(opt_tensors)}
        self._steps.append(step)
        drop = []
        if self.max_to_keep is not None:
            while len(self._steps) > self.max_to_keep:
                drop.append(self._steps.pop(0))
        # opt_state: the optimizer state's scalars by path, None without one
        state = {"format": FORMAT, "step": step, "opt_state": scalars}
        self._thread = threading.Thread(
            target=self._commit, args=(step, snapshot, state, meta, drop),
            name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        return True

    def _commit(self, step, snapshot, state, meta, drop) -> None:
        try:
            tmp = os.path.join(self.directory, f"{step}{TMP_MARK}{uuid.uuid4().hex}")
            os.makedirs(tmp)
            for item, tensors in snapshot.items():
                if tensors:
                    os.makedirs(os.path.join(tmp, item))
                    write_safetensors(os.path.join(tmp, item, TENSOR_FILE), tensors.items())
            if meta is not None:
                with open(os.path.join(tmp, META_FILE), "w") as fh:
                    json.dump(meta, fh)
            with open(os.path.join(tmp, STATE_FILE), "w") as fh:
                json.dump(state, fh)
            os.rename(tmp, self._step_dir(step))
            for old in drop:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        except Exception as exc:  # raised again by wait()
            self._error = exc

    def wait(self) -> None:
        """Block until the queued save is committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def restore(self, step: Optional[int] = None, device: Any = "cpu") -> Dict[str, Any]:
        """A step (the latest if ``step`` is None) as ``{"step", "params",
        "opt_state" (if saved), "meta" (if saved)}``, its tensors on
        ``device``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._step_dir(step)
        if not is_step_dir(path):
            raise FileNotFoundError(f"{path} is not a step directory of {FORMAT}")
        device = resolve_device(device)
        with open(os.path.join(path, STATE_FILE)) as fh:
            state = json.load(fh)

        def load(item):
            if not os.path.isdir(os.path.join(path, item)):
                return {}
            return {name: tensor.to(device)
                    for name, tensor in _read_tensors(os.path.join(path, item)).items()}

        out: Dict[str, Any] = {"step": state["step"], "params": load("params")}
        if state["opt_state"] is not None:
            out["opt_state"] = _unflatten({**load("opt_state"), **state["opt_state"]})
        if os.path.exists(os.path.join(path, META_FILE)):
            with open(os.path.join(path, META_FILE)) as fh:
                out["meta"] = json.load(fh)
        return out

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def close(self) -> None:
        self.wait()


def config_meta(config) -> Dict[str, Any]:
    """JSON-safe dict of a model config dataclass: its scalar fields, the
    dtype by name, the rope-scaling tuple as a list."""
    out = {
        k: v for k, v in dataclasses.asdict(config).items()
        if isinstance(v, (int, float, str, bool))
    }
    dtype = getattr(config, "dtype", None)
    if dtype is not None:
        out["dtype"] = str(dtype).removeprefix("torch.")
    if getattr(config, "rope_scaling", None) is not None:
        out["rope_scaling"] = list(config.rope_scaling)
    return out


def save_model(directory: str, config, params: Dict[str, torch.Tensor]) -> None:
    """One-shot weights-only export (serving artifact): step 0 with the
    model config as meta."""
    manager = CheckpointManager(directory, max_to_keep=1)
    manager.save(0, params, meta={"model_config": config_meta(config)})
    manager.close()


def load_model(directory: str, config_cls=None, device: Any = "cuda"):
    """(config, params on ``device``) from the latest step under
    ``directory`` (a :func:`save_model` export or a trainer's save
    directory). ``config_cls`` defaults to the port's LlamaConfig."""
    if config_cls is None:
        from langstream_tpu_torch.providers.torch_local.model import LlamaConfig

        config_cls = LlamaConfig
    manager = CheckpointManager(directory)
    restored = manager.restore(device=device)
    manager.close()
    meta = restored.get("meta") or {}
    config = config_cls.from_dict(meta.get("model_config", {}))
    return config, restored["params"]
