"""HDF5 trajectory container (port of
``multimodalfilter_tpu/data/trajectories_file.py``).

Layout: one HDF5 group per trajectory, named by integer index ("0", "1", ...),
one dataset per key; trajectory count in the root attribute ``count``.

``h5py`` is imported when a file is opened, not with the module: the port
imports and runs its eval without it, on data synthesised in memory
(``data/cache.py::cached_trajectories``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


class TrajectoriesFile:
    def __init__(self, path: str, mode: str = "r", verbose: bool = False):
        self.path = path
        self.mode = mode
        self.verbose = verbose
        self._file = None
        self._pending: Dict[str, List[np.ndarray]] = {}

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "TrajectoriesFile":
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(
                f"reading or writing {self.path} needs h5py, which is not "
                "installed; without it set MMF_TPU_SYNTHESIZE_DATA=1 to "
                "synthesise the door datasets in memory (no file must be cached)"
            ) from exc
        self._file = h5py.File(self.path, self.mode)
        return self

    def __exit__(self, *args):
        self._file.close()
        self._file = None

    def _require_open(self):
        if self._file is None:
            raise RuntimeError("TrajectoriesFile must be used as a context manager")
        return self._file

    # -- reading ------------------------------------------------------------
    def __len__(self) -> int:
        f = self._require_open()
        if "count" in f.attrs:
            return int(f.attrs["count"])
        return len(f.keys())

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        f = self._require_open()
        group = f[str(index)]
        return {k: np.asarray(group[k]) for k in group.keys()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]

    # -- writing ------------------------------------------------------------
    def add_timestep(self, content: Dict[str, np.ndarray]) -> None:
        """Buffer one timestep of the in-progress trajectory."""
        for k, v in content.items():
            self._pending.setdefault(k, []).append(np.asarray(v))

    def complete_trajectory(self) -> None:
        """Flush the buffered timesteps as a new trajectory group."""
        f = self._require_open()
        index = len(self)
        group = f.create_group(str(index))
        for k, steps in self._pending.items():
            group.create_dataset(k, data=np.stack(steps, axis=0))
        f.attrs["count"] = index + 1
        self._pending = {}
        if self.verbose:
            print(f"[TrajectoriesFile] wrote trajectory {index} to {self.path}")

