"""Experiment manager: checkpoints, metadata, named optimizers, logging
(port of ``multimodalfilter_tpu/experiments/buddy.py``).

Labelled checkpoints, one per curriculum phase; submodule-level checkpoint
surgery (``load_checkpoint_module``); a clearable dict of named optimizers
(the curricula clear it between phases, train_door.py:159); a JSON metadata
store; and scalar logging.

The checkpoint format is the port's own:
``torch.save({"params": state_dict, "steps": int, "optimizers": {name:
optimizer.state_dict()}})`` to ``<checkpoint_dir>/<experiment>/<label>.pt``,
read with ``torch.load(weights_only=True)`` onto the model's device. The
state-dict keys are the dotted flax param paths, which address submodules as
the JAX package's paths do. JAX checkpoints (``.ckpt``, msgpack) are not
read here: convert their params with ``weights.params_from_jax``.
Directories are created when first written to.

Two checkpoint backends write that one format, chosen by
``Buddy(checkpoint_backend=...)`` or else ``MMF_TPU_CKPT_BACKEND``, with
the JAX package's names so that one launcher environment means the same to
both packages:

- ``msgpack`` (the default): ``save_checkpoint`` writes the file before it
  returns (the JAX package's msgpack file; here ``torch.save``).
- ``orbax`` (the JAX package's asynchronous orbax writer; here a writer
  thread): ``save_checkpoint`` copies the parameters, the step count and
  the named optimizers' state onto the host (on CUDA, copies enqueued on
  the stream ahead of any later work), starts the write and returns, so
  the write overlaps what runs next and the parameters may change in place
  at once. The thread writes a temporary file beside the checkpoint
  and renames it into place, so a reader never sees a partial file.
  ``wait_for_checkpoints`` joins the write in flight, and every read calls
  it first; an error on the writer thread is raised there, or at the next
  save or read. A save joins the write before it, so writes commit in
  order. The thread is not a daemon: a process that exits with a write in
  flight finishes it.

Reads take either backend's files alike, so no format is detected.

In a multi-device run (``torch.distributed`` initialised) rank 0 alone
writes checkpoints, metadata and logs. After a synchronous save every rank
waits at a barrier, so that any rank may then read it. Under ``orbax`` that
barrier moves into ``wait_for_checkpoints``: every rank records the save in
flight, rank 0 joins its writer, then every rank meets at the barrier. So
a save, a read or a wait after an asynchronous save is collective: every
rank makes it together, as the CLIs do. The other ranks keep their
metadata in memory.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import torch

from .._device import Device, resolve_device
from ..parallel.mesh import barrier, is_writer
from ..train.optim import load_optimizer_state
from ..utils.pytree import path_matches_prefix, torch_path_segments
from .logging import MetricLogger

DEFAULT_CHECKPOINT_DIR = "checkpoints"
DEFAULT_METADATA_DIR = "metadata"
DEFAULT_LOG_DIR = "logs"
CHECKPOINT_SUFFIX = ".pt"
CHECKPOINT_BACKENDS = ("msgpack", "orbax")


def _to_host(tree):
    """A copy of `tree` (dicts, lists and tuples of tensors and other
    values) with every tensor copied to host memory. A CUDA tensor's copy
    is enqueued on its stream (into pinned memory) and not waited for."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            return tree.detach().to("cpu", non_blocking=True)
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write_atomically(state, path: str) -> None:
    """``torch.save`` to a temporary name of this process beside `path`,
    then a rename onto `path`."""
    directory, name = os.path.split(path)
    tmp = os.path.join(directory, f".{name}.{os.getpid()}.tmp")
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class _OptimizerDict(dict):
    """Buddy's named-optimizer dict; `.clear()` (the curricula's
    between-phase optimizer reset) also drops any checkpoint-restored
    warm-start states stashed for not-yet-created optimizers."""

    def __init__(self, owner: "Buddy"):
        super().__init__()
        self._owner = owner

    def clear(self) -> None:
        super().clear()
        self._owner._pending_optimizer_state.clear()


class Buddy:
    def __init__(
        self,
        experiment_name: str,
        model=None,
        *,
        checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR,
        metadata_dir: str = DEFAULT_METADATA_DIR,
        log_dir: str = DEFAULT_LOG_DIR,
        checkpoint_backend: Optional[str] = None,
        device: Device = None,
        verbose: bool = True,
    ):
        backend = checkpoint_backend or os.environ.get("MMF_TPU_CKPT_BACKEND", "msgpack")
        if backend not in CHECKPOINT_BACKENDS:
            raise ValueError(
                f"checkpoint_backend must be 'msgpack' or 'orbax', got {backend!r}")
        self._checkpoint_backend = backend
        # The asynchronous backend's write in flight: its thread, and the
        # error it raised; every rank's record that a save is in flight.
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._save_in_flight = False
        self._device = device
        self.experiment_name = experiment_name
        self._checkpoint_dir = checkpoint_dir
        self._metadata_dir = metadata_dir
        self._verbose = verbose
        self._model = None
        self._metadata: Dict[str, Any] = {}
        # Checkpointed optimizer states for optimizers that do not exist yet
        # (the train loops create them lazily); train.optim.get_named_optimizer
        # consumes them, so a resumed phase starts with warm Adam moments.
        # _optimizer_dict.clear() drops them too, or a later optimizer of the
        # same name would warm-start from a pre-reset checkpoint.
        self._pending_optimizer_state: Dict[str, Any] = {}
        self._optimizer_dict: Dict[str, torch.optim.Optimizer] = _OptimizerDict(self)
        self._steps = 0
        self._logger = MetricLogger(log_dir, experiment_name, write=is_writer())
        self._load_metadata_file()
        if model is not None:
            self.attach_model(model)

    # -- model ---------------------------------------------------------------
    def attach_model(self, model) -> None:
        self._model = model

    @property
    def model(self):
        if self._model is None:
            raise RuntimeError("No model attached")
        return self._model

    @property
    def device(self) -> torch.device:
        """The device of the attached model's parameters; before a model is
        attached, the device the port's entry points choose (``cuda:0``, or
        the `device` this buddy was given). Raises where CUDA is missing and
        no device was given."""
        if self._model is not None:
            return next(self._model.params.parameters()).device
        device = resolve_device(self._device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    # -- optimizer steps counter ----------------------------------------------
    @property
    def optimizer_steps(self) -> int:
        return self._steps

    def increment_steps(self, n: int = 1) -> None:
        self._steps += n

    # -- metadata --------------------------------------------------------------
    @property
    def metadata(self) -> Dict[str, Any]:
        return self._metadata

    def set_metadata(self, content: Dict[str, Any]) -> None:
        self._metadata = dict(content)
        self._write_metadata_file()

    def add_metadata(self, content: Dict[str, Any]) -> None:
        self._metadata.update(content)
        self._write_metadata_file()

    @property
    def _metadata_path(self) -> str:
        return os.path.join(self._metadata_dir, f"{self.experiment_name}.json")

    def _write_metadata_file(self) -> None:
        if not is_writer():
            return
        os.makedirs(self._metadata_dir, exist_ok=True)
        with open(self._metadata_path, "w") as f:
            json.dump(self._metadata, f, indent=2, default=str)

    def _load_metadata_file(self) -> None:
        if os.path.exists(self._metadata_path):
            with open(self._metadata_path) as f:
                self._metadata = json.load(f)

    # -- checkpoints -------------------------------------------------------------
    def _checkpoint_path(self, label: Optional[str],
                         experiment_name: Optional[str] = None) -> str:
        name = experiment_name or self.experiment_name
        label = label if label is not None else f"{self._steps:016d}"
        return os.path.join(self._checkpoint_dir, name, label + CHECKPOINT_SUFFIX)

    def save_checkpoint(self, label: Optional[str] = None) -> str:
        """Write the checkpoint `label` (default: the step count) and return
        its path; under ``orbax`` the write is still in flight."""
        if self._checkpoint_backend == "orbax":
            return self._save_checkpoint_async(label)
        self.wait_for_checkpoints()
        state = {
            "params": self.model.params.state_dict(),
            "steps": self._steps,
            "optimizers": {name: opt.state_dict()
                           for name, opt in self._optimizer_dict.items()},
        }
        path = self._checkpoint_path(label)
        if is_writer():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(state, path)
            if self._verbose:
                print(f"[buddy] saved checkpoint: {path}")
        barrier()
        return path

    def _save_checkpoint_async(self, label: Optional[str]) -> str:
        # The write before this one commits first (and its error surfaces).
        self.wait_for_checkpoints()
        path = self._checkpoint_path(label)
        if is_writer():
            # The snapshot: host copies, so the optimizer step that follows
            # may overwrite the parameters and moments in place. On CUDA
            # the copies are enqueued on the stream ahead of that step, and
            # the writer waits for them.
            state = _to_host({
                "params": self.model.params.state_dict(),
                "steps": self._steps,
                "optimizers": {name: opt.state_dict()
                               for name, opt in self._optimizer_dict.items()},
            })
            device = self.device
            copied = (torch.cuda.current_stream(device).record_event()
                      if device.type == "cuda" else None)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._writer = threading.Thread(target=self._write, args=(state, path, copied),
                                            name=f"checkpoint {path}")
            self._writer.start()
            if self._verbose:
                print(f"[buddy] checkpoint save started: {path}")
        self._save_in_flight = True
        return path

    def _write(self, state, path: str, copied) -> None:
        try:
            if copied is not None:
                copied.synchronize()
            _write_atomically(state, path)
        except BaseException as exc:  # raised again by wait_for_checkpoints
            self._write_error = exc

    def wait_for_checkpoints(self) -> None:
        """Block until every asynchronous save has committed, and raise the
        writer's error if it failed. In a multi-device run every rank waits
        at a barrier for rank 0's writes (every rank calls this together).
        Nothing to do on the ``msgpack`` backend or with no save in flight."""
        if not self._save_in_flight:
            return
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._save_in_flight = False
        barrier()
        error, self._write_error = self._write_error, None
        if error is not None:
            raise error

    def _read_checkpoint(self, label: Optional[str],
                         experiment_name: Optional[str] = None) -> Dict[str, Any]:
        self.wait_for_checkpoints()
        path = self._checkpoint_path(label, experiment_name)
        if not os.path.exists(path):
            if label is not None:
                raise FileNotFoundError(f"No checkpoint {path}")
            # Fall back to the most recently written checkpoint (the
            # reference Buddy's "latest" semantics).
            exp_dir = os.path.dirname(path)
            candidates = [
                os.path.join(exp_dir, p) for p in os.listdir(exp_dir)
                if p.endswith(CHECKPOINT_SUFFIX)
            ] if os.path.isdir(exp_dir) else []
            if not candidates:
                raise FileNotFoundError(f"No checkpoints found in {exp_dir}")
            path = max(candidates, key=os.path.getmtime)
        device = next(self.model.params.parameters()).device
        state = torch.load(path, weights_only=True, map_location=device)
        if self._verbose:
            print(f"[buddy] read checkpoint: {path}")
        return state

    def load_checkpoint(self, label: Optional[str] = None,
                        experiment_name: Optional[str] = None) -> None:
        state = self._read_checkpoint(label, experiment_name)
        self.model.params.load_state_dict(state["params"], strict=True)
        self._steps = int(state.get("steps", 0))
        # Optimizer states: loaded into the named optimizers that exist and
        # match; stashed for those not created yet (get_named_optimizer
        # warm-starts them). A full restore defines the whole optimizer
        # state, so a stash left by an earlier load is dropped first.
        self._pending_optimizer_state.clear()
        for name, saved in state.get("optimizers", {}).items():
            if name not in self._optimizer_dict:
                self._pending_optimizer_state[name] = saved
                continue
            if not load_optimizer_state(self._optimizer_dict[name], saved):
                if self._verbose:
                    print(f"[buddy] optimizer {name!r} state incompatible; skipped")

    def load_checkpoint_module(self, source: str, target: Optional[str] = None,
                               label: Optional[str] = None,
                               experiment_name: Optional[str] = None) -> None:
        """Copy one submodule's parameters from a checkpoint into the
        attached model, addressed by dotted paths (e.g.
        "measurement_model.crossmodal_weight_model")."""
        target = source if target is None else target
        params = self._read_checkpoint(label, experiment_name)["params"]
        skip, dst = len(torch_path_segments(source)), torch_path_segments(target)
        subtree = {".".join(dst + k.split(".")[skip:]): v for k, v in params.items()
                   if path_matches_prefix(tuple(k.split(".")), source)}
        if not subtree:
            raise KeyError(f"no parameters under {source!r} in the checkpoint")
        current = self.model.params.state_dict()
        missing = sorted(set(subtree) - set(current))
        if missing:
            raise KeyError(f"the model has no parameters {missing}")
        with torch.no_grad():
            for key, value in subtree.items():
                if current[key].shape != value.shape:
                    raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                                     f"model shape {tuple(current[key].shape)}")
                current[key].copy_(value)
        if self._verbose:
            print(f"[buddy] loaded module {source!r} -> {target!r}")

    def load_torch_checkpoint(self, path: str) -> None:
        """Import a trained reference (PyTorch, fannypack) checkpoint into
        the attached model (the path mapping of
        ``experiments/torch_import.py``)."""
        from .torch_import import load_reference_checkpoint

        state = load_reference_checkpoint(path, self.model.definition)
        self.model.params.load_state_dict(state, strict=True)
        if self._verbose:
            print(f"[buddy] imported torch checkpoint: {path}")

    # -- logging ---------------------------------------------------------------
    def log_scope(self, scope: str):
        return self._logger.log_scope(scope)

    def log_scalar(self, name: str, value: float) -> None:
        self._logger.log_scalar(name, value, step=self._steps)
