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
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..train.optim import load_optimizer_state
from .logging import MetricLogger

DEFAULT_CHECKPOINT_DIR = "checkpoints"
DEFAULT_METADATA_DIR = "metadata"
DEFAULT_LOG_DIR = "logs"
CHECKPOINT_SUFFIX = ".pt"


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
        verbose: bool = True,
    ):
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
        self._logger = MetricLogger(log_dir, experiment_name)
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
        state = {
            "params": self.model.params.state_dict(),
            "steps": self._steps,
            "optimizers": {name: opt.state_dict()
                           for name, opt in self._optimizer_dict.items()},
        }
        path = self._checkpoint_path(label)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(state, path)
        if self._verbose:
            print(f"[buddy] saved checkpoint: {path}")
        return path

    def _read_checkpoint(self, label: Optional[str],
                         experiment_name: Optional[str] = None) -> Dict[str, Any]:
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
        src = source + "." if source else ""
        dst = target + "." if target else ""
        subtree = {dst + k[len(src):]: v for k, v in params.items() if k.startswith(src)}
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

    # -- logging ---------------------------------------------------------------
    def log_scope(self, scope: str):
        return self._logger.log_scope(scope)

    def log_scalar(self, name: str, value: float) -> None:
        self._logger.log_scalar(name, value, step=self._steps)
