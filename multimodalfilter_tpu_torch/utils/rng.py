"""The PRNG switch ``MMF_TPU_RBG`` (port of
``multimodalfilter_tpu/utils/rng.py``).

In the JAX package the knob picks one of JAX's PRNG implementations for the
process: unset, ``0`` or ``off`` leave the default (threefry), ``1``/``rbg``
and ``unsafe``/``unsafe_rbg`` select the TPU's RngBitGenerator draws. The
port draws from ``torch.Generator``, which has no such choice: it accepts the
values that leave the default and refuses every other, so that a serving
configuration written for the TPU does not silently draw another stream.
``StatefulFilter`` applies the refusal when it is built.
"""

from __future__ import annotations

import os
from typing import Optional

# MMF_TPU_RBG values that leave JAX's default PRNG: the only ones the port
# accepts.
_DEFAULT = ("", "0", "off", "false")


def prng_impl_from_env(env: Optional[dict] = None) -> Optional[str]:
    """The PRNG implementation ``MMF_TPU_RBG`` selects: None (the default,
    ``torch.Generator``), or raises for a value that picks another."""
    raw = (env if env is not None else os.environ).get("MMF_TPU_RBG", "0")
    if raw.strip().lower() not in _DEFAULT:
        raise NotImplementedError(
            f"MMF_TPU_RBG={raw!r} picks one of JAX's PRNG implementations; the "
            "PyTorch port draws from torch.Generator: unset it or set it to 0"
        )
    return None


def configure_prng_from_env() -> Optional[str]:
    """Apply ``MMF_TPU_RBG``: there is nothing to switch in the port, so
    this checks the value (``prng_impl_from_env``) and returns None."""
    return prng_impl_from_env()
