"""Door-task training CLI (port of ``scripts/door_task/train_door.py``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.train_door \
        --model-type DoorCrossmodalParticleFilter --experiment-name NAME [--resume]

The JAX CLI's flags (``--model-type`` from ``DoorTask.model_types``, the
dataset flags, ``--serving``, which sets MMF_TPU_SERVING=1 (the curriculum
trains without the serving transforms and evaluates with them), and the
parallelism flags: under ``torchrun --nproc-per-node N``, ``--data-parallel
N`` trains e2e BPTT data-parallel and evaluates so, and
``--pipeline-stages``/``--particle-shards`` run the eval passes on their
grid, as in the JAX CLI; rank 0 writes the checkpoints, metadata and logs),
its metadata keys, its per-class curricula (``run_curriculum``) run through
``ResumableCurriculum``, and its final ``run_eval``. Runs on ``cuda`` unless
``--device`` says otherwise. Checkpoints, metadata and logs go to
``checkpoints/``, ``metadata/`` and ``logs/`` under the working directory;
datasets come from the repo's ``.cache/`` (where ``h5py`` is missing, set
MMF_TPU_SYNTHESIZE_DATA=1 to synthesise them in memory).
"""

from __future__ import annotations

import argparse
import datetime
from typing import Dict, Optional

from ...crossmodal import door_models, eval_helpers, train_helpers
from ...crossmodal.resume import ResumableCurriculum
from ...crossmodal.tasks import DoorTask
from ...data import set_cache_path
from ...experiments import Buddy
from ...filtering.wrappers import freeze_module, unfreeze_module
from ...parallel.cli import (
    add_parallelism_args,
    add_serving_arg,
    apply_serving_arg,
    meshes_from_args,
)
from ...utils import get_git_commit_hash, pdb_safety_net
from .eval_door import REPO_CACHE_DIR

Task = DoorTask


def _now() -> str:
    return datetime.datetime.now().strftime("%b %d, %Y @ %-H:%M:%S")


def _parser(task=Task, description: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description or __doc__.split("\n\n")[0])
    parser.add_argument("--model-type", type=str, required=True,
                        choices=task.model_types.keys())
    parser.add_argument("--experiment-name", type=str, required=True)
    parser.add_argument("--notes", type=str, default="(none)")
    task.add_dataset_arguments(parser)
    add_parallelism_args(parser)
    add_serving_arg(parser)
    parser.add_argument(
        "--resume", action="store_true",
        help="resume an interrupted run: phases whose labeled checkpoint "
        "exists are skipped, the latest completed phase's checkpoint is "
        "restored (parameters, step count and optimizer states), and training "
        "continues from the first incomplete phase (crossmodal/resume.py)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the model runs on (default cuda)")
    return parser


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Train on `argv`'s model type through its curriculum, then evaluate;
    returns the eval results. `cache_dir` replaces the repo's ``.cache/`` as
    the dataset cache."""
    return run(Task, run_curriculum, argv, cache_dir=cache_dir)


def run(task, curriculum, argv=None, *, cache_dir: Optional[str] = None,
        description: Optional[str] = None) -> Dict[str, float]:
    """The train CLI of `task` with its per-class `curriculum` (the door
    and push CLIs share it)."""
    args = _parser(task, description).parse_args(argv)
    apply_serving_arg(args)
    # Before the model is built: on CUDA this makes the rank's card current.
    mesh, pipeline_mesh = meshes_from_args(args, device=args.device)

    model_type = args.model_type
    dataset_args = task.get_dataset_args(args)

    set_cache_path(cache_dir or REPO_CACHE_DIR)
    pdb_safety_net()

    # Create model + buddy, persist experiment metadata.
    filter_model = task.model_types[model_type](device=args.device)
    if args.sequential_image_rate > 1:
        filter_model.know_image_blackout = True
    buddy = Buddy(args.experiment_name, filter_model)
    buddy.set_metadata({
        "model_type": model_type,
        "dataset_args": dataset_args,
        "train_start_time": _now(),
        "commit_hash": get_git_commit_hash(__file__),
        "notes": args.notes,
    })

    train_trajectories = task.get_train_trajectories(**dataset_args)
    # The pipeline applies to the eval passes only: the curricula's
    # subsequence lengths (1, 3, 7 and 15 steps) divide no stage count, so
    # --data-parallel is the training axis (train_e2e(pipeline_mesh=...)
    # serves curricula whose lengths divide).
    train_helpers.configure(buddy=buddy, trajectories=train_trajectories, mesh=mesh)
    eval_helpers.configure(
        buddy=buddy, task=task, dataset_args=dataset_args,
        # With both flags the grid carries the data axis; eval takes it alone.
        mesh=None if pipeline_mesh is not None else mesh,
        pipeline_mesh=pipeline_mesh, pipeline_microbatches=args.pipeline_microbatches,
    )

    rc = ResumableCurriculum(buddy, train_helpers, eval_helpers, enabled=args.resume)
    rc.run(curriculum, filter_model)

    buddy.add_metadata({"train_end_time": _now()})
    eval_results = eval_helpers.run_eval()
    buddy.add_metadata({"eval_results": eval_results})
    # The last checkpoint committed (MMF_TPU_CKPT_BACKEND=orbax writes it
    # beside the eval), and a failed write raised, before the CLI returns.
    buddy.wait_for_checkpoints()
    return eval_results


def run_curriculum(filter_model, buddy, train_helpers, eval_helpers):
    """The per-class curricula (scripts/door_task/train_door.py:125-427 of
    the JAX package)."""
    dm = door_models

    if isinstance(filter_model, dm.DoorLSTMFilter):
        train_helpers.train_e2e(subsequence_length=2, epochs=2, batch_size=32)
        buddy.save_checkpoint("phase0")
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=16, epochs=15, batch_size=32)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase1")

    elif isinstance(filter_model, dm.DoorCrossmodalParticleFilter):
        # (Checked before DoorParticleFilter because the curricula differ;
        # Seq5 lands here too.)
        measurement_model = filter_model.measurement_model
        freeze_module(measurement_model.crossmodal_weight_model)

        # Dynamics pretraining: warm-start from another experiment's
        # checkpoint when there is one, else train from scratch.
        try:
            buddy.load_checkpoint_module(
                "dynamics_model", experiment_name="pf_blackout0.0_q_tune"
            )
        except FileNotFoundError:
            train_helpers.train_pf_dynamics_single_step(epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
        buddy.save_checkpoint("phase1")

        freeze_module(filter_model.dynamics_model)
        buddy._optimizer_dict.clear()

        # Pre-train measurement model (image).
        measurement_model.enabled_models = [True, False]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        buddy.save_checkpoint("phase2")

        # Pre-train measurement model (proprioception + haptics).
        measurement_model.enabled_models = [False, True]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase3")
        buddy._optimizer_dict.clear()

        measurement_model.enabled_models = [True, True]
        unfreeze_module(measurement_model.crossmodal_weight_model)
        freeze_module(measurement_model.measurement_models)
        buddy._optimizer_dict.clear()

        # Train everything end-to-end.
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        for _ in range(4):
            train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4")

    elif isinstance(filter_model, dm.DoorUnimodalParticleFilter):
        measurement_model = filter_model.measurement_model

        train_helpers.train_pf_dynamics_single_step(epochs=5)
        buddy.save_checkpoint("phase0")
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=4, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=8, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
        buddy.save_checkpoint("phase1")

        freeze_module(filter_model.dynamics_model)

        measurement_model.enabled_models = [True, False]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        buddy.save_checkpoint("phase2")

        measurement_model.enabled_models = [False, True]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase3")

        measurement_model.enabled_models = [True, True]
        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        for _ in range(4):
            train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4")

    elif isinstance(filter_model, dm.DoorParticleFilter):
        train_helpers.train_pf_dynamics_single_step(epochs=10)
        buddy.save_checkpoint("phase0")
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=4, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=8, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase1")

        freeze_module(filter_model.dynamics_model)
        train_helpers.train_pf_measurement(epochs=5, batch_size=64)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase2")

        train_helpers.train_e2e(subsequence_length=4, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        for _ in range(4):
            train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase3")

    elif isinstance(filter_model, dm.DoorCrossmodalKalmanFilter):
        image_model = filter_model.filter_models[0]
        force_model = filter_model.filter_models[1]

        freeze_module(filter_model.crossmodal_weight_model)

        train_helpers.train_pf_dynamics_single_step(epochs=5, model=image_model)
        buddy.save_checkpoint("phase0")
        buddy.load_checkpoint_module(
            source="filter_models.0.dynamics_model",
            target="filter_models.1.dynamics_model",
            label="phase0",
        )

        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=4, epochs=5, model=image_model
        )
        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=8, epochs=5, model=image_model
        )
        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=16, epochs=5, model=image_model
        )
        buddy.save_checkpoint("phase1")
        buddy.load_checkpoint_module(
            source="filter_models.0.dynamics_model",
            target="filter_models.1.dynamics_model",
            label="phase1",
        )

        train_helpers.train_virtual_sensor(epochs=5, batch_size=64, model=image_model)
        train_helpers.train_virtual_sensor(epochs=5, batch_size=64, model=force_model)
        buddy.save_checkpoint("phase2")

        # Pre-train each child EKF end-to-end with named optimizers.
        filter_model.enabled_models = [True, False]
        for length, epochs in ((4, 3), (8, 3), (16, 5)):
            train_helpers.train_e2e(
                subsequence_length=length, epochs=epochs, batch_size=32,
                optimizer_name="image_ekf",
            )
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase3-image")

        filter_model.enabled_models = [False, True]
        for length, epochs in ((4, 3), (8, 3), (16, 5)):
            train_helpers.train_e2e(
                subsequence_length=length, epochs=epochs, batch_size=32,
                optimizer_name="force_ekf",
            )
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase3-force")

        filter_model.enabled_models = [True, True]
        unfreeze_module(filter_model.crossmodal_weight_model)
        freeze_module(filter_model.filter_models)
        train_helpers.train_e2e(
            subsequence_length=3, epochs=1, batch_size=32, optimizer_name="freeze_ekf"
        )
        buddy.save_checkpoint("phase4-freeze")

        unfreeze_module(filter_model.filter_models)
        train_helpers.train_e2e(
            subsequence_length=3, epochs=5, batch_size=32, measurement_initialize=False
        )
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase4-length3")
        for _ in range(3):
            train_helpers.train_e2e(
                subsequence_length=4, epochs=5, batch_size=32,
                measurement_initialize=False,
            )
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4-length4")
        for _ in range(2):
            train_helpers.train_e2e(
                subsequence_length=6, epochs=5, batch_size=32,
                measurement_initialize=False,
            )
            eval_helpers.log_eval()
            print("kalman e2e")
        buddy.save_checkpoint("phase4-done")

    elif isinstance(
        filter_model,
        (dm.DoorMeasurementCrossmodalKalmanFilter, dm.DoorMeasurementUnimodalKalmanFilter),
    ):
        # The measurement-fusion EKFs share the plain EKF's curriculum.
        _ekf_curriculum(filter_model, buddy, train_helpers, eval_helpers)

    elif isinstance(filter_model, dm.DoorUnimodalKalmanFilter):
        image_model = filter_model.filter_models[0]
        force_model = filter_model.filter_models[1]

        train_helpers.train_pf_dynamics_single_step(epochs=5, model=image_model)
        buddy.save_checkpoint("phase0")
        buddy.load_checkpoint_module(
            source="filter_models.0.dynamics_model",
            target="filter_models.1.dynamics_model",
            label="phase0",
        )
        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=4, epochs=5, model=image_model
        )
        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=8, epochs=5, model=image_model
        )
        train_helpers.train_pf_dynamics_recurrent(
            subsequence_length=16, epochs=5, model=image_model
        )
        buddy.save_checkpoint("phase1")
        buddy.load_checkpoint_module(
            source="filter_models.0.dynamics_model",
            target="filter_models.1.dynamics_model",
            label="phase1",
        )

        train_helpers.train_virtual_sensor(epochs=3, batch_size=64, model=image_model)
        train_helpers.train_virtual_sensor(epochs=3, batch_size=64, model=force_model)
        buddy.save_checkpoint("phase2")

        filter_model.enabled_models = [True, False]
        train_helpers.train_e2e(subsequence_length=4, epochs=3, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=3, batch_size=32)
        eval_helpers.log_eval()
        print("kalman image")
        train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)

        filter_model.enabled_models = [False, True]
        train_helpers.train_e2e(subsequence_length=4, epochs=3, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=3, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
        print("kalman force")
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase3")

        filter_model.enabled_models = [True, True]
        freeze_module(filter_model.filter_models)
        train_helpers.train_e2e(subsequence_length=4, epochs=1, batch_size=32)
        unfreeze_module(filter_model.filter_models)

        train_helpers.train_e2e(
            subsequence_length=3, epochs=5, batch_size=32, measurement_initialize=True
        )
        eval_helpers.log_eval()
        for _ in range(3):
            train_helpers.train_e2e(
                subsequence_length=4, epochs=5, batch_size=32,
                measurement_initialize=True,
            )
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4-length4")
        for _ in range(2):
            train_helpers.train_e2e(
                subsequence_length=6, epochs=5, batch_size=32,
                measurement_initialize=True,
            )
            eval_helpers.log_eval()
            print("kalman e2e")
        buddy.save_checkpoint("phase4-final")

    elif isinstance(filter_model, dm.DoorKalmanFilter):
        _ekf_curriculum(filter_model, buddy, train_helpers, eval_helpers)

    else:
        assert False, "No training curriculum found for model type"


def _ekf_curriculum(filter_model, buddy, train_helpers, eval_helpers):
    """The plain virtual-sensor EKF's curriculum, which the measurement-fusion
    EKFs share."""
    train_helpers.train_pf_dynamics_single_step(epochs=10)
    buddy.save_checkpoint("phase0")
    train_helpers.train_pf_dynamics_recurrent(subsequence_length=4, epochs=5)
    train_helpers.train_pf_dynamics_recurrent(subsequence_length=8, epochs=5)
    train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
    eval_helpers.log_eval()
    buddy.save_checkpoint("phase1")

    freeze_module(filter_model.dynamics_model)
    train_helpers.train_virtual_sensor(epochs=10, batch_size=64)
    eval_helpers.log_eval()
    buddy.save_checkpoint("phase2")

    train_helpers.train_e2e(
        subsequence_length=4, epochs=5, batch_size=32, measurement_initialize=True
    )
    eval_helpers.log_eval()
    train_helpers.train_e2e(
        subsequence_length=8, epochs=5, batch_size=32, measurement_initialize=True
    )
    eval_helpers.log_eval()
    for _ in range(4):
        train_helpers.train_e2e(
            subsequence_length=16, epochs=5, batch_size=32, measurement_initialize=True
        )
        eval_helpers.log_eval()
    buddy.save_checkpoint("phase3")


if __name__ == "__main__":
    main()
