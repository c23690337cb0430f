"""A one-off measurement, not a suite test (it defines none): the door
unimodal Kalman filter's curriculum (``scripts/door_task/train_door.py``)
run by the JAX package or by the port on the CPU, on the same 8 + 8
synthetic door trajectories (the door files of ``chip_smoke.py``'s KF
curricula: seeds 2, 3 train and 0, 1 eval, four trajectories a file of
100-124 steps) from the same numpy weights (seed 10: kernels uniform on
+-sqrt(3 / fan_in), zero biases), printing the state RMSE (the root mean
square of the three normalised dimensions' raw RMSEs) of the untrained
model and at every checkpoint the curriculum saves. Both packages draw the
batch order from the same seeds and the Kalman filters draw no random
numbers, so the two runs differ by rounding only.

    JAX_PLATFORMS=cpu python tests/test_torch_port_c5_curricula.py {jax,port} OUT_DIR

``PORT_THREADS`` sets the port's torch threads (default 8).
"""

import contextlib
import io
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FILES = (("panda_door_pull_100.hdf5", 2), ("panda_door_push_100.hdf5", 3),
         ("panda_door_pull_10.hdf5", 0), ("panda_door_push_10.hdf5", 1))
DATASET_ARGS = dict(use_vision=True, use_proprioception=True, use_haptics=True,
                    image_blackout_ratio=0.0, sequential_image_rate=1)
CLASS = "DoorUnimodalKalmanFilter"


def _numpy_tree(shapes, seed=10):
    import jax
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "bias":
            return np.zeros(leaf.shape, np.float32)
        limit = np.sqrt(3.0 / int(np.prod(leaf.shape[:-1])))
        return rng.uniform(-limit, limit, size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def main(side: str, out_dir: str) -> dict:
    os.environ.update({"MMF_TPU_SYNTH_TRAJ": "4", "MMF_TPU_SYNTH_T": "100",
                       "MMF_TPU_OFFLINE": "1", "MMF_TPU_EVAL_DEVICE_THROUGHPUT": "0"})
    os.environ.pop("MMF_TPU_SYNTHESIZE_DATA", None)
    sys.path[:0] = [str(REPO), str(REPO / "scripts" / "door_task")]
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from crossmodal.tasks import DoorTask as JaxDoorTask
    from multimodalfilter_tpu.filtering import wrappers as jwrappers
    from multimodalfilter_tpu_torch.data import synthetic

    work = Path(out_dir) / side
    cache_dir = Path(out_dir) / "cache"
    if not cache_dir.exists():
        cache_dir.mkdir(parents=True)
        for name, seed in FILES:
            synthetic.synthesize_named_dataset(name, str(cache_dir / name), seed=seed)
    real_jit = jwrappers.jax.jit
    jwrappers.jax.jit = lambda fn: lambda *a: jax.eval_shape(fn, *a)
    tree = _numpy_tree(JaxDoorTask.model_types[CLASS]().params)
    jwrappers.jax.jit = real_jit

    if side == "port":
        import torch

        torch.set_num_threads(int(os.environ.get("PORT_THREADS", "8")))
        from multimodalfilter_tpu_torch.crossmodal import eval_helpers, train_helpers
        from multimodalfilter_tpu_torch.crossmodal.tasks import DoorTask as task
        from multimodalfilter_tpu_torch.data import cache
        from multimodalfilter_tpu_torch.experiments import Buddy
        from multimodalfilter_tpu_torch.scripts.door_task import train_door

        cache.set_cache_path(str(cache_dir))
        model = task.model_types[CLASS](device="cpu")
        model.load_jax_params(tree)
        os.makedirs(work, exist_ok=True)
        os.chdir(work)
        buddy = Buddy("c5", model, log_dir=str(work / "logs"), verbose=False)
    else:
        import jax.numpy as jnp

        import crossmodal.eval_helpers as eval_helpers
        import crossmodal.train_helpers as train_helpers
        import multimodalfilter_tpu.data.cache as cache
        import train_door
        from multimodalfilter_tpu.experiments import Buddy

        task = JaxDoorTask
        cache._cache_path = str(cache_dir)
        model = task.model_types[CLASS]()
        model.params = jax.tree_util.tree_map(jnp.asarray, tree)
        buddy = Buddy("c5", model, checkpoint_dir=str(work / "checkpoints"),
                      metadata_dir=str(work / "metadata"), log_dir=str(work / "logs"),
                      verbose=False)

    train_helpers.configure(buddy=buddy,
                            trajectories=task.get_train_trajectories(**DATASET_ARGS))
    eval_helpers.configure(buddy=buddy, task=task, dataset_args=dict(DATASET_ARGS))

    def state_rmse():
        with contextlib.redirect_stdout(io.StringIO()):
            raw = np.asarray(eval_helpers.run_eval()["raw_rmse"], dtype=np.float64)
        return {"raw_rmse": raw.tolist(), "state_rmse": float(np.sqrt(np.mean(raw ** 2)))}

    out = {"side": side, "untrained": state_rmse(), "checkpoints": {}}
    real_save, t0 = buddy.save_checkpoint, time.time()

    def save(label=None, *args, **kwargs):
        result = real_save(label, *args, **kwargs)
        out["checkpoints"][label] = {**state_rmse(), "s": time.time() - t0}
        print(label, json.dumps(out["checkpoints"][label]), file=sys.stderr, flush=True)
        return result

    buddy.save_checkpoint = save
    with contextlib.redirect_stdout(sys.stderr):
        train_door.run_curriculum(model, buddy, train_helpers, eval_helpers)
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2])))
