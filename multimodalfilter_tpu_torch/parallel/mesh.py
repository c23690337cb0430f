"""Process-group meshes (port of ``multimodalfilter_tpu/parallel/mesh.py``).

The port runs one process per device, PyTorch's SPMD idiom: a rank holds
only its shard, and the collectives between ranks are explicit
(``parallel/collectives.py``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes over the ranks
of the initialised world, in rank order (rank r sits at the coordinate that
``np.unravel_index(r, shape)`` gives).

The backend follows the model's device: NCCL for ``cuda``, gloo for the CPU.
Launch with ``torchrun --nproc-per-node N``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT``; ``initialize_distributed`` reads them.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import Device, resolve_device

DEFAULT_TIMEOUT_S = 600.0


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def world_size() -> int:
    """The initialised world's size, else torchrun's ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def is_writer() -> bool:
    """True on the rank that writes files (rank 0, or a single process)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank of a world of more than one; nothing otherwise."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def initialize_distributed(device: Device = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the world torchrun describes in the environment and return its
    size. A no-op returning the size where a group is initialised already,
    and returning 1 in a single process with no such environment.

    On CUDA it first makes ``LOCAL_RANK`` the current device: the port's
    entry points resolve to plain ``cuda``, so the current device decides
    where a rank's tensors go, and it must be set before a model is built."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 1
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(device), init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def _ensure_world_of_one(device: Device) -> None:
    """A process group of one in this process (an in-memory store), so that
    a mesh of one device exists without a launcher, as ``create_mesh(1)``
    does in the JAX package."""
    device = resolve_device(device)
    dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                            world_size=1)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(n_devices: Optional[int] = None,
                axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, *,
                device: Device = None) -> DeviceMesh:
    """A mesh of `shape` (default: all `n_devices` on the first axis, 1 on
    the others) named `axis_names`, over the whole world (joined first from
    torchrun's environment where no group is initialised). Raises when the
    world's size differs from the mesh's; a smaller mesh is never built in
    its place. In a single process a mesh of one device starts a world of
    one (`device` picks its backend; default ``cuda``)."""
    axis_names = tuple(axis_names)
    if shape is not None:
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} does not name axes {axis_names}")
        want = math.prod(shape)
        if n_devices is not None and n_devices != want:
            raise ValueError(f"create_mesh({n_devices}) with shape {tuple(shape)}")
        n_devices = want
    initialize_distributed(device)
    size = world_size()
    if n_devices is None:
        n_devices = size
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if n_devices != size:
        raise RuntimeError(
            f"a mesh of {n_devices} device(s) needs a world of {n_devices} rank(s), "
            f"one per device, and this world has {size}: launch with "
            f"torchrun --nproc-per-node {n_devices}"
        )
    if not dist.is_initialized():
        _ensure_world_of_one(device)
    ranks = torch.arange(n_devices).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axis_names)


def create_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                       axis_names: Sequence[str]) -> DeviceMesh:
    """A mesh over several machines: axis i has ``ici_shape[i] *
    dcn_shape[i]`` ranks, of which the ``dcn_shape`` part runs across
    machines (outermost: torchrun numbers ranks machine by machine,
    ``LOCAL_WORLD_SIZE`` to a machine) and the ``ici_shape`` part within
    one. Keep per-step collectives (pipe, particle) at dcn 1 so that they
    stay inside a machine. With every dcn 1 this is ``create_mesh`` of
    `ici_shape`."""
    ici_shape, dcn_shape = tuple(ici_shape), tuple(dcn_shape)
    if not len(ici_shape) == len(dcn_shape) == len(axis_names):
        raise ValueError(f"{ici_shape}, {dcn_shape} and {tuple(axis_names)} differ in length")
    if all(d == 1 for d in dcn_shape):
        return create_mesh(axis_names=axis_names, shape=ici_shape)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if math.prod(ici_shape) != local:
        raise RuntimeError(f"ici_shape {ici_shape} needs {math.prod(ici_shape)} ranks a "
                           f"machine, and a machine has {local}")
    shape = tuple(i * d for i, d in zip(ici_shape, dcn_shape))
    size = world_size()
    if math.prod(shape) != size:
        raise RuntimeError(f"a hybrid mesh of {shape} needs {math.prod(shape)} ranks; "
                           f"the world has {size}")
    if not dist.is_initialized():
        raise RuntimeError("a hybrid mesh needs an initialised world "
                           "(initialize_distributed)")
    ranks = torch.from_numpy(hybrid_rank_grid(ici_shape, dcn_shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axis_names))


def hybrid_rank_grid(ici_shape: Sequence[int], dcn_shape: Sequence[int]) -> np.ndarray:
    """The ranks of a hybrid mesh: machine-major rank numbers laid out so
    that index ``d * ici + i`` of axis k is machine coordinate d and local
    coordinate i."""
    k = len(ici_shape)
    grid = np.arange(math.prod(ici_shape) * math.prod(dcn_shape)).reshape(
        tuple(dcn_shape) + tuple(ici_shape))
    order = [axis for pair in zip(range(k), range(k, 2 * k)) for axis in pair]
    return grid.transpose(order).reshape(
        tuple(i * d for i, d in zip(ici_shape, dcn_shape)))


# -- axis helpers -------------------------------------------------------------


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, name: Optional[str]) -> int:
    """The size of `mesh`'s axis `name`; 1 where there is no mesh or no
    such axis."""
    if mesh is None or name is None or name not in axis_names(mesh):
        return 1
    return mesh.size(axis_names(mesh).index(name))


def axis_index(mesh, name: Optional[str]) -> int:
    """This rank's coordinate on `mesh`'s axis `name` (0 without one)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axis_peer(mesh, name: str, index: int) -> int:
    """The global rank at coordinate `index` on axis `name`, with this
    rank's coordinates on every other axis."""
    coordinate = list(mesh.get_coordinate())
    coordinate[axis_names(mesh).index(name)] = index
    return int(mesh.mesh[tuple(coordinate)])


def mesh_fingerprint(mesh) -> tuple:
    """The mesh's identity as a cache key: axes, shape and ranks."""
    return (axis_names(mesh), tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()))


def block(size: int, mesh, name: Optional[str]) -> slice:
    """This rank's contiguous block of `size` entries split over axis
    `name`. Raises when they do not split evenly."""
    parts = axis_size(mesh, name)
    if size % parts:
        raise ValueError(f"{size} does not split over the {parts}-way {name!r} axis")
    step = size // parts
    start = axis_index(mesh, name) * step
    return slice(start, start + step)


def local_rows(x, mesh, axis_name: str = "data", axis: int = 0):
    """This rank's rows of a global batch `x` (a tensor, an array, or a
    dict, tuple or list of them) along `axis`: concatenating every rank's
    rows in mesh order gives `x` back. The port's counterpart of the JAX
    package's ``global_batch_from_process_local``, ``data_sharding`` and
    ``shard_batch``: an SPMD rank holds its rows and no global array."""
    if isinstance(x, dict):
        return {k: local_rows(v, mesh, axis_name, axis) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "shape"):
        parts = [local_rows(v, mesh, axis_name, axis) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)
    rows = block(x.shape[axis], mesh, axis_name)
    index = (slice(None),) * axis + (rows,)
    return x[index]
