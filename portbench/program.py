"""The benchmark's one door into the program: build a configuration's
model through its public class and load the benchmark's weights into its
parameters. Everything else a driver does goes through the facade
(``StatefulFilter``) or ``train/loops.py::train_e2e``."""

from __future__ import annotations

import dataclasses
import importlib
import os

from portbench import inputs

# Environment switches the facade reads when it is built
# (filtering/wrappers.py::apply_serving_knobs); a run sets its mix's own and
# clears the rest, so the caller's shell cannot change a cell.
KNOB_PREFIX = "MMF_TPU_"


def build_model(run):
    """The configuration's model class, built on the run's device under the
    mix's knobs, with the benchmark's weights loaded into its parameters."""
    cfg, traffic = run.config, run.traffic
    for key in [k for k in os.environ if k.startswith(KNOB_PREFIX)]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in traffic.get("knobs", {}).items()})
    module, cls = cfg["model"].split(":")
    model = getattr(importlib.import_module(module), cls)(device=run.device)
    defn = model.definition
    if defn.state_dim != cfg["state_dim"]:
        raise ValueError(f"{cls} has state dim {defn.state_dim}, the config {cfg['state_dim']}")
    m_key = "num_particles_train" if traffic["driver"] == "train_e2e" else "num_particles_eval"
    if getattr(defn, m_key) != traffic["M"]:
        model.definition = dataclasses.replace(defn, **{m_key: traffic["M"]})
    weights = inputs.make_weights(cfg, run.seed, run.device)
    model.params.load_state_dict(weights, strict=True)
    return model, weights
