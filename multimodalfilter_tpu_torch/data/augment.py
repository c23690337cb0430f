"""Device-side sensor-fault injection (port of
``multimodalfilter_tpu/data/augment.py``).

The eval repeats re-mask the device-resident images rather than reload the
eval set. Distribution: i.i.d. Bernoulli(keep = 1 - ratio) per frame, the
mask broadcast over pixels, as the loader's host-side mask
(``crossmodal/tasks/_door.py::make_image_mask``). A ``torch.Generator`` on the
images' device takes the place of the JAX key.
"""

from __future__ import annotations

import torch


def apply_image_blackout(generator: torch.Generator, images: torch.Tensor,
                         ratio: float) -> torch.Tensor:
    """Zero out each frame independently with probability `ratio`.

    images: (..., H, W) with arbitrary leading frame axes."""
    frame_shape = images.shape[:-2]
    keep = torch.rand(frame_shape, generator=generator, device=images.device) > ratio
    return images * keep[..., None, None].to(images.dtype)


def apply_sequential_rate(images: torch.Tensor, rate: int, axis: int = 0) -> torch.Tensor:
    """Keep one frame every `rate` along `axis`, zero the rest (the
    deterministic variant)."""
    length = images.shape[axis]
    mask = (torch.arange(length, device=images.device) % rate) == 0
    shape = [1] * images.ndim
    shape[axis] = length
    return images * mask.reshape(shape).to(images.dtype)
