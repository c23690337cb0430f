"""The port's seeded init (``weights.init_params``) against flax's default
kernel init, ``jax.nn.initializers.lecun_normal()``, at one Dense and one
Conv shape on the CPU: both draw nothing beyond the cut at two standard
deviations, 2 sqrt(1/fan_in) / 0.87962566, and both have a sample variance
near 1/fan_in.

Tolerance on the variance: 10% of 1/fan_in. The sample variance of n draws
of a normal cut at +-2 has a relative standard error of sqrt((k - 1) / n)
with kurtosis k = 2.36, 1.8% at the Dense shape (n = 4,096) and 1.0% at the
Conv shape (n = 12,800): the limit is over five of them. An uncut normal of
the same variance puts ~2.3% of its draws beyond the cut."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from multimodalfilter_tpu_torch.weights import init_params

VAR_RTOL = 0.1
TRUNCATED_NORMAL_STD = 0.87962566103423978


@pytest.mark.parametrize("module,flax_shape", [
    (nn.Linear(64, 64), (64, 64)),  # Dense kernel (in, out)
    (nn.Conv2d(16, 32, 5), (5, 5, 16, 32)),  # Conv kernel HWIO
])
def test_init_params_draws_as_flax_lecun_normal(module, flax_shape):
    init_params(module, seed=0)
    port = module.weight.detach().numpy()
    flax = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), flax_shape))
    assert port.size == flax.size
    fan_in = port[0].size
    assert fan_in == int(np.prod(flax_shape[:-1]))
    cut = 2 * fan_in ** -0.5 / TRUNCATED_NORMAL_STD
    for draws in (port, flax):
        assert np.abs(draws).max() <= cut * (1 + 1e-6)
        np.testing.assert_allclose(draws.var() * fan_in, 1.0, rtol=VAR_RTOL)
    assert not module.bias.detach().any()
