"""PyTorch/CUDA port of ``multimodalfilter_tpu``.

The module layout mirrors the JAX package, so each counterpart is found by
path (``filtering/pf.py`` here ports ``multimodalfilter_tpu/filtering/pf.py``).
Networks are ``nn.Module``s whose attribute names are the flax scope names,
so state-dict keys are the flax param paths (``weights.py`` converts a flax
param tree). The particle-filter step tail runs as hand-written CUDA kernels
on the GPU: in eval ``ops/pf_kernels.py`` (``csrc/pf_resample.cu``), in
training, forward and backward, ``ops/pf_estimate.py``
(``csrc/pf_estimate.cu``). ``crossmodal/train_helpers.py`` drives the
training loops of ``train/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without a device they raise rather than fall back.
"""

from .types import ParticleBelief

__all__ = ["ParticleBelief"]
