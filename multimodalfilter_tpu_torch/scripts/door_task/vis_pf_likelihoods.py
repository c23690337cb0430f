"""Per-modality PF measurement log-likelihood landscapes (port of
``scripts/door_task/vis_pf_likelihoods.py``, the script form of the
reference's ``scripts/door_task/vis_pf_likelihoods.ipynb``).

    python -m multimodalfilter_tpu_torch.scripts.door_task.vis_pf_likelihoods \
        --experiment-name cmpf_run --timestep 100 --output likelihoods.png

Loads a trained crossmodal PF checkpoint, sweeps a 2D grid of states around
the ground truth at one timestep of one eval trajectory, and renders each
modality's measurement log-likelihood, and the gated fusion of them, as a
heatmap. Two parts: ``likelihood_grid`` computes the grid on the model's
device; ``render`` draws it with matplotlib, imported only there (a machine
without matplotlib computes the grid and raises ``ImportError`` on
rendering).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

MODALITY_NAMES = ("image", "pos+sensors")


def likelihood_grid(filter_model, trajectory, *, timestep: int = 50, grid_size: int = 41,
                    grid_radius: float = 2.0, dims: Sequence[int] = (0, 1)) -> dict:
    """The measurement log-likelihoods of a crossmodal PF (`filter_model`)
    over a ``grid_size`` x ``grid_size`` grid of states around the ground
    truth of `trajectory` (a ``Trajectory``) at `timestep` (clipped to its
    last step), the state dims `dims` offset by up to ``grid_radius``.

    Returns {"axis": (g,) offsets, "dims", "timestep", "names": a name per
    modality, "log_likelihoods": (K, g, g) per modality, "fused": (g, g)},
    numpy, rows indexed by the offset of dims[1], columns by dims[0]."""
    t = min(timestep, trajectory.states.shape[0] - 1)
    g = grid_size
    d0, d1 = dims
    axis = np.linspace(-grid_radius, grid_radius, g, dtype=np.float32)
    states = np.tile(trajectory.states[t], (g * g, 1))
    xs, ys = np.meshgrid(axis, axis)
    states[:, d0] += xs.ravel()
    states[:, d1] += ys.ravel()
    device = filter_model.device
    states = torch.as_tensor(states[None], dtype=torch.float32, device=device)
    observations = {k: torch.as_tensor(v[t:t + 1], dtype=torch.float32, device=device)
                    for k, v in trajectory.observations.items()}

    mm = filter_model.definition.measurement_model
    with torch.no_grad():
        per_modality = [sub.log_likelihoods(states, observations).reshape(g, g)
                        for sub in mm.measurement_models]
        fused = mm.log_likelihoods(states, observations).reshape(g, g)
    names = [MODALITY_NAMES[i] if i < len(MODALITY_NAMES) else str(i)
             for i in range(len(per_modality))]
    return {"axis": axis, "dims": (d0, d1), "timestep": t, "names": names,
            "log_likelihoods": torch.stack(per_modality).cpu().numpy(),
            "fused": fused.cpu().numpy()}


def render(grid: dict, output: str) -> str:
    """Draw `grid` (``likelihood_grid``'s result) as one heatmap a modality
    plus the fused one, the ground truth starred, into `output`."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("rendering the likelihood grid needs matplotlib, which is not "
                          "installed here (likelihood_grid runs without it)") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    axis, (d0, d1) = grid["axis"], grid["dims"]
    panels = [*zip((f"log-likelihood: {n}" for n in grid["names"]), grid["log_likelihoods"]),
              ("fused (crossmodal gate)", grid["fused"])]
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 4))
    for ax, (title, values) in zip(axes, panels):
        im = ax.imshow(values, origin="lower", extent=[axis[0], axis[-1], axis[0], axis[-1]],
                       cmap="viridis")
        ax.plot(0, 0, "r*", markersize=12)
        ax.set_title(title)
        ax.set_xlabel(f"Δ state[{d0}]")
        ax.set_ylabel(f"Δ state[{d1}]")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(output, dpi=120)
    plt.close(fig)
    return output


def main(argv=None, *, cache_dir: Optional[str] = None) -> dict:
    """The CLI on `argv`: the grid of a checkpointed model, rendered into
    ``--output``. Returns the grid."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiment-name", type=str, required=True)
    parser.add_argument("--checkpoint-label", type=str, default=None)
    parser.add_argument("--trajectory", type=int, default=0)
    parser.add_argument("--timestep", type=int, default=50)
    parser.add_argument("--grid-size", type=int, default=41)
    parser.add_argument("--grid-radius", type=float, default=2.0)
    parser.add_argument("--dims", type=int, nargs=2, default=(0, 1),
                        help="state dims to sweep (default: theta, hinge-x)")
    parser.add_argument("--output", type=str, default="pf_likelihoods.png")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the model runs on (default cuda)")
    args = parser.parse_args(argv)

    from ...crossmodal import door_models  # noqa: F401  (registers the door models)
    from ...crossmodal.tasks import DoorTask
    from ...data import set_cache_path
    from ...experiments import Buddy
    from .eval_door import REPO_CACHE_DIR

    set_cache_path(cache_dir or REPO_CACHE_DIR)
    buddy = Buddy(args.experiment_name)
    filter_model = DoorTask.model_types[buddy.metadata["model_type"]](device=args.device)
    buddy.attach_model(filter_model)
    buddy.load_checkpoint(label=args.checkpoint_label)

    trajectories = DoorTask.get_eval_trajectories(**buddy.metadata["dataset_args"])
    grid = likelihood_grid(filter_model, trajectories[args.trajectory],
                           timestep=args.timestep, grid_size=args.grid_size,
                           grid_radius=args.grid_radius, dims=args.dims)
    print(f"wrote {render(grid, args.output)}")
    return grid


if __name__ == "__main__":
    main()
