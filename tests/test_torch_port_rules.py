"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package (its ``native`` host engine included) and needs no ``h5py`` to
import, its entry points never move to the CPU on their own, and its kernel
wrapper never falls back to the plain version for a non-CPU tensor."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multimodalfilter_tpu_torch.crossmodal import door_models as tdoor
from multimodalfilter_tpu_torch.ops import _build, pf_kernels

REPO = Path(__file__).resolve().parents[1]


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodalfilter_tpu_torch as pkg\n"
        "for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'multimodalfilter_tpu', 'crossmodal'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_WALK_WITHOUT_H5PY = (
    "import importlib, pkgutil, sys\n"
    "sys.modules['h5py'] = None\n"
    "import multimodalfilter_tpu_torch as pkg\n"
    "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
    "for name in names:\n"
    "    importlib.import_module(name)\n"
    "print('ok', len(names))\n"
)


def test_package_imports_without_h5py():
    """The card's machine has no h5py: every module imports without it (the
    data layer imports it only when a file is opened)."""
    out = subprocess.run([sys.executable, "-c", _WALK_WITHOUT_H5PY], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) > 40


def test_package_imports_no_native_engine():
    """The port keeps its own numpy copies of the JAX package's native host
    engine (multimodalfilter_tpu.native): no module of the port names it.
    The import walk of test_package_imports_no_jax, which bans the whole
    JAX package, covers it at run time; this holds the sources to it."""
    pkg = REPO / "multimodalfilter_tpu_torch"
    offenders = [str(p.relative_to(REPO)) for p in pkg.rglob("*.py")
                 if "multimodalfilter_tpu.native" in p.read_text()
                 or "from multimodalfilter_tpu import" in p.read_text()]
    assert offenders == []


def test_model_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdoor.DoorCrossmodalParticleFilter()


def test_model_on_cpu_when_asked():
    model = tdoor.DoorUnimodalParticleFilter(device="cpu")
    assert {p.device.type for p in model.params.parameters()} == {"cpu"}
    assert model.generator.device.type == "cpu"


def test_kernel_build_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.load_library("pf_resample")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.build()


def test_kernel_wrapper_does_not_fall_back_for_non_cpu_tensors():
    n, m, d = 2, 8, 3
    meta = dict(device="meta")
    args = (torch.empty(n, m, **meta), torch.empty(n, m, **meta),
            torch.empty(n, m, d, **meta), torch.empty(n, m, **meta))
    before = pf_kernels.launch_b1.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pf_kernels.pf_update_and_resample(*args)
    assert pf_kernels.launch_b1.launches == before
