"""Export a trained filter as a serving bundle (port of
``scripts/export_serving.py``).

    python -m multimodalfilter_tpu_torch.scripts.export_serving \
        --experiment-name my_cmpf --task door --batch 16 --timesteps 100 \
        --output bundles/my_cmpf_T100_N16 [--serving] [--device cpu] [--verify]

Freezes the eval rollout (``initialize_beliefs`` and ``forward_loop``) of a
checkpointed model into a bundle (``experiments/export.py``): two exported
programs, the parameters and a ``meta.json``. The serving host loads it
with ``load_serving_bundle``, with no model code. Shapes are static: export
one bundle per (timesteps, batch). ``--device`` (default ``cuda``) is where
the model runs and where the bundle will run. ``--verify`` reloads the
bundle and asserts that it replays the model bitwise on random inputs.
Checkpoints and metadata are read from ``checkpoints/`` and ``metadata/``
under the working directory.
"""

from __future__ import annotations

import argparse
import os

from ..parallel.cli import add_serving_arg, apply_serving_arg


def main(argv=None) -> str:
    """Run the export CLI on `argv`; returns the bundle's path."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiment-name", type=str, required=True)
    parser.add_argument("--checkpoint-label", type=str, default=None)
    parser.add_argument("--task", choices=("door", "push"), default="door")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--timesteps", type=int, default=100)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the model and the bundle run on (default cuda)")
    parser.add_argument("--verify", action="store_true",
                        help="reload the bundle and check that it replays the source "
                             "model bitwise on random inputs")
    add_serving_arg(parser)
    args = parser.parse_args(argv)
    apply_serving_arg(args)  # before the model is built: the knobs are read then

    import numpy as np
    import torch

    from ..crossmodal import door_models, push_models  # noqa: F401  (registers them)
    from ..crossmodal.tasks import DoorTask, PushTask
    from ..experiments import Buddy
    from ..experiments.export import export_serving_bundle, load_serving_bundle

    task = DoorTask if args.task == "door" else PushTask
    buddy = Buddy(args.experiment_name)
    model_type = buddy.metadata["model_type"]
    filter_model = task.model_types[model_type](device=args.device)
    filter_model.eval()
    buddy.attach_model(filter_model)
    buddy.load_checkpoint(label=args.checkpoint_label)

    # Both tasks share the observation and control layout (tasks/_door.py,
    # tasks/_push.py): 32x32 grayscale images, 3-dim gripper position,
    # 7-dim gripper sensors, 7-dim controls.
    t, n, d = args.timesteps, args.batch, filter_model.state_dim
    rng = np.random.default_rng(0)
    shapes = {"image": (t, n, 32, 32), "gripper_pos": (t, n, 3), "gripper_sensors": (t, n, 7)}
    obs = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    ctrl = rng.normal(size=(t, n, 7)).astype(np.float32)
    path = export_serving_bundle(filter_model, args.output, observations=obs, controls=ctrl)
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    print(f"[export] {model_type} ({args.task}) T={t} N={n} on {args.device} -> {path} "
          f"({size / 1e6:.1f} MB)")

    if args.verify:
        mean = np.zeros((n, d), np.float32)
        cov = np.broadcast_to(np.eye(d, dtype=np.float32) * 0.1, (n, d, d))
        filter_model.initialize_beliefs(mean=mean, covariance=cov)
        want = filter_model.forward_loop(observations=obs, controls=ctrl)
        served = load_serving_bundle(path, seed=0)
        served.initialize_beliefs(mean=mean, covariance=cov)
        got = served.forward_loop(observations=obs, controls=ctrl)
        if not torch.equal(want, got):
            raise AssertionError("the bundle does not replay the model bitwise")
        print(f"[export] verify OK: the bundle replays the model bitwise "
              f"({tuple(got.shape)} estimates)")
    return path


if __name__ == "__main__":
    main()
