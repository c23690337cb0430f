"""Start a world of ranks from one process: ``spawn(fn, world_size, device,
*args)`` runs ``fn(rank, world_size, *args)`` in `world_size` new
processes, each in the initialised process group of the world (NCCL and
device ``cuda:rank`` for ``cuda``, gloo for the CPU), and returns their
results in rank order.

The processes start with the ``spawn`` method, and the group meets through
a ``file://`` store in a temporary directory, so that worlds started side
by side never race for a TCP port. Every group has a timeout, and the world
a wall-clock limit: when a rank fails or the world outlives `timeout_s`,
every rank is killed and ``spawn`` raises, so a fault never hangs the
caller (a failed rank leaves at once, without tearing its group down, and
its traceback comes back in the error). The tests, ``chip_smoke.py`` and
``parallel/dryrun.py`` use it;
users launch with ``torchrun --nproc-per-node N``.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for

DEFAULT_TIMEOUT_S = 300.0


def _rank_main(rank: int, fn: Callable, world_size: int, device: str, workdir: str,
               timeout_s: float) -> None:
    device = torch.device(device)
    args = torch.load(Path(workdir) / "args.pt", weights_only=False)
    # What torchrun would set, so that code of the port reading the
    # environment (initialize_distributed, the kernel build) sees the world.
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world_size),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world_size)})
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend_for(device), init_method=f"file://{workdir}/store", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
    except BaseException:
        # Leave without tearing the group down: a teardown waits on the ranks
        # still in a collective with this one, which would wait for ever.
        error = traceback.format_exc()
        (Path(workdir) / f"error{rank}.txt").write_text(error)
        sys.stderr.write(f"rank {rank} of {world_size} failed:\n{error}")
        sys.stderr.flush()
        os._exit(1)
    torch.save(result, Path(workdir) / f"result{rank}.pt")
    dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str = "cpu", *args: Any,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on `world_size` ranks and return
    the ranks' results (saved with ``torch.save``) in rank order. `fn` must
    be importable by name (a module-level function): the ranks import its
    module. Raises when a rank raises (``RuntimeError`` with every failed
    rank's traceback), or when the world is not done within `timeout_s`
    seconds; in both cases every rank is stopped first."""
    device = str(device)
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"a world of {world_size} CUDA ranks needs {world_size} cards, "
                           f"one per rank; this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="mmf_world_") as workdir:
        # The arguments go through a file that every rank reads: handed to
        # each process on its start, megabytes of them take seconds a rank.
        torch.save(args, Path(workdir) / "args.pt")
        context = mp.start_processes(
            _rank_main, args=(fn, world_size, device, workdir, timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not context.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world_size} ranks outlived "
                                       f"{timeout_s:.0f} s")
        except mp.ProcessExitedException as exc:
            errors = sorted(Path(workdir).glob("error*.txt"))
            if not errors:
                raise
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"{e.stem}:\n{e.read_text()}" for e in errors)) from exc
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
            for process in context.processes:
                process.join(timeout=30)
        return [torch.load(Path(workdir) / f"result{rank}.pt", weights_only=False)
                for rank in range(world_size)]
