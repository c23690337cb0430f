"""Push-task training CLI (port of ``scripts/push_task/train_push.py``).

    python -m multimodalfilter_tpu_torch.scripts.push_task.train_push \
        --model-type PushCrossmodalParticleFilter --experiment-name NAME \
        [--kloss_dataset] [--resume]

The door train CLI's shape (``scripts/door_task/train_door.py``: the JAX
CLI's flags, metadata keys, ``--resume`` through ``ResumableCurriculum``,
``--serving``, ``--device`` with ``cuda`` the default, the parallelism
flags under ``torchrun``) over ``PushTask`` (its dataset flags add
``--kloss_dataset``) and the eight per-class push curricula of
``run_curriculum``. As in the JAX CLI, the Seq5 branch binds the filter's
measurement model before use (the reference's leaves it unbound), and
pretrains from scratch when its warm-start experiment is missing.
"""

from __future__ import annotations

from typing import Dict, Optional

from ...crossmodal import push_models
from ...crossmodal.tasks import PushTask
from ...filtering.wrappers import freeze_module, unfreeze_module
from ..door_task import train_door

Task = PushTask


def main(argv=None, *, cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Train on `argv`'s model type through its curriculum, then evaluate;
    returns the eval results. `cache_dir` replaces the repo's ``.cache/`` as
    the dataset cache."""
    return train_door.run(Task, run_curriculum, argv, cache_dir=cache_dir,
                          description=__doc__.split("\n\n")[0])


def run_curriculum(filter_model, buddy, train_helpers, eval_helpers):
    """The per-class curricula (scripts/push_task/train_push.py:126-451 of
    the JAX package)."""
    pm = push_models

    if isinstance(filter_model, pm.PushLSTMFilter):
        # 25 x (1 epoch of length-16 e2e, eval each).
        for _ in range(25):
            train_helpers.train_e2e(subsequence_length=16, epochs=1, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase1")

    elif isinstance(filter_model, pm.PushCrossmodalParticleFilterSeq5):
        # Warm-start the dynamics and measurement models from a trained
        # cmpf_blackout0.0 experiment, then train the gate end-to-end with
        # blackout awareness. Without that experiment (Buddy raises
        # FileNotFoundError), pretrain the same modules from scratch, as the
        # JAX CLI does.
        measurement_model = filter_model.measurement_model
        try:
            buddy.load_checkpoint_module(
                "dynamics_model", "dynamics_model", experiment_name="cmpf_blackout0.0"
            )
            buddy.load_checkpoint_module(
                "measurement_model.measurement_models",
                "measurement_model.measurement_models",
                experiment_name="cmpf_blackout0.0",
            )
        except FileNotFoundError:
            # From-scratch stand-in for the warm start: the dynamics +
            # per-modality measurement pretraining phases of the base
            # PushCrossmodalParticleFilter curriculum.
            freeze_module(measurement_model.crossmodal_weight_model)
            train_helpers.train_pf_dynamics_single_step(epochs=5)
            train_helpers.train_pf_dynamics_recurrent(subsequence_length=4, epochs=5)
            train_helpers.train_pf_dynamics_recurrent(subsequence_length=8, epochs=5)
            train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
            freeze_module(filter_model.dynamics_model)
            measurement_model.enabled_models = [True, False]
            train_helpers.train_pf_measurement(epochs=3, batch_size=64)
            measurement_model.enabled_models = [False, True]
            train_helpers.train_pf_measurement(epochs=3, batch_size=64)

        measurement_model.enabled_models = [True, True]
        unfreeze_module(measurement_model.crossmodal_weight_model)
        freeze_module(measurement_model.measurement_models)

        train_helpers.train_e2e(subsequence_length=3, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        for _ in range(4):
            train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4")

    elif isinstance(filter_model, pm.PushCrossmodalParticleFilter):
        measurement_model = filter_model.measurement_model
        freeze_module(measurement_model.crossmodal_weight_model)

        train_helpers.train_pf_dynamics_single_step(epochs=5)
        buddy.save_checkpoint("phase0")
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=4, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=8, epochs=5)
        train_helpers.train_pf_dynamics_recurrent(subsequence_length=16, epochs=5)
        buddy.save_checkpoint("phase1")

        freeze_module(filter_model.dynamics_model)

        measurement_model.enabled_models = [True, False]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=3, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        buddy.save_checkpoint("phase2")

        measurement_model.enabled_models = [False, True]
        train_helpers.train_pf_measurement(epochs=3, batch_size=64)
        train_helpers.train_e2e(subsequence_length=3, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=16, epochs=20, batch_size=32)
        eval_helpers.log_eval()
        buddy.save_checkpoint("phase3")

        measurement_model.enabled_models = [True, True]
        unfreeze_module(measurement_model.crossmodal_weight_model)
        freeze_module(measurement_model.measurement_models)

        train_helpers.train_e2e(subsequence_length=3, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        train_helpers.train_e2e(subsequence_length=8, epochs=5, batch_size=32)
        eval_helpers.log_eval()
        for _ in range(4):
            train_helpers.train_e2e(subsequence_length=16, epochs=5, batch_size=32)
            eval_helpers.log_eval()
        buddy.save_checkpoint("phase4")

    elif isinstance(filter_model, pm.PushUnimodalParticleFilter):
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

    elif isinstance(filter_model, pm.PushParticleFilter):
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

    elif isinstance(filter_model, pm.PushCrossmodalKalmanFilter):
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
        (pm.PushMeasurementCrossmodalKalmanFilter, pm.PushMeasurementUnimodalKalmanFilter),
    ):
        _ekf_curriculum(filter_model, buddy, train_helpers, eval_helpers)

    elif isinstance(filter_model, pm.PushUnimodalKalmanFilter):
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

        train_helpers.train_virtual_sensor(epochs=5, batch_size=64, model=image_model)
        train_helpers.train_virtual_sensor(epochs=5, batch_size=64, model=force_model)
        buddy.save_checkpoint("phase2")

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

    elif isinstance(filter_model, pm.PushKalmanFilter):
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
    train_helpers.train_virtual_sensor(epochs=10, batch_size=32)
    eval_helpers.log_eval()
    buddy.save_checkpoint("phase2")

    train_helpers.train_e2e(
        subsequence_length=4, epochs=5, batch_size=32, measurement_initialize=False
    )
    eval_helpers.log_eval()
    train_helpers.train_e2e(
        subsequence_length=8, epochs=5, batch_size=32, measurement_initialize=False
    )
    eval_helpers.log_eval()
    for _ in range(4):
        train_helpers.train_e2e(
            subsequence_length=16, epochs=5, batch_size=32,
            measurement_initialize=False,
        )
        eval_helpers.log_eval()
    buddy.save_checkpoint("phase3")



if __name__ == "__main__":
    main()
