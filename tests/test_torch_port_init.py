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



# An orthogonal draw's rows are orthonormal: W W^T = I up to the fp32
# rounding of the QR and of the product (~1e-6 over 512 terms).
ORTHO_ATOL = 1e-5


@pytest.fixture(scope="module")
def lstm_draws():
    """(an OptimizedLSTMCell(64, 512) after init_params, flax's lecun_normal
    draw of an input kernel, its orthogonal draw of a recurrent kernel),
    made once on one torch thread (the suite's workers share the cores)."""
    from multimodalfilter_tpu_torch.models import OptimizedLSTMCell

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = OptimizedLSTMCell(64, 512)
        init_params(cell, seed=0)
    finally:
        torch.set_num_threads(threads)
    key = jax.random.PRNGKey(0)
    return (cell, np.asarray(jax.nn.initializers.lecun_normal()(key, (64, 512))),
            np.asarray(jax.nn.initializers.orthogonal()(key, (512, 512))))


@pytest.mark.parametrize("kernel", [f"{kind}{gate}" for kind in "ih" for gate in "ifgo"])
def test_init_params_draws_lstm_cell_as_flax(kernel, lstm_draws):
    """An LSTM cell's eight kernels as flax's OptimizedLSTMCell draws them:
    the input kernels (i*, (64, 512) in flax) as lecun_normal, the recurrent
    ones (h*, (512, 512)) orthogonal (flax's recurrent_kernel_init). Both
    fail on torch.nn.LSTMCell's init, uniform on +-1/sqrt(H)."""
    cell, lecun, orthogonal = lstm_draws
    port = getattr(cell, kernel).weight.detach().numpy()
    if kernel.startswith("i"):
        flax = lecun
        cut = 2 * 64 ** -0.5 / TRUNCATED_NORMAL_STD
        for draws in (port, flax):
            assert np.abs(draws).max() <= cut * (1 + 1e-6)
            np.testing.assert_allclose(draws.var() * 64, 1.0, rtol=VAR_RTOL)
    else:
        flax = orthogonal
        for draws in (port, flax):
            np.testing.assert_allclose(draws @ draws.T, np.eye(512), rtol=0, atol=ORTHO_ATOL)
        assert not cell.get_parameter(f"{kernel}.bias").detach().any()
    assert port.shape == flax.T.shape
