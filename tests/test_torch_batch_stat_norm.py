"""``batch_stat_norm`` (BatchNorm on the batch's own statistics) against the
reference package's ``repro.models.layers.batch_stat_norm`` on the CPU: fp32
and bf16 inputs, 1-D, 2-D and 3-D, the statistics over every leading dim.

Tolerances: fp32 1e-5 absolute and relative (the two frameworks sum the mean
and the variance in other orders); bf16 2e-2, one bf16 rounding of the
output, as the bf16 kernel checks hold."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.models import layers as jax_layers
from repro_torch.models import layers

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(37,), (64, 48), (3, 29, 16), (2, 5, 7, 8)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])


@pytest.mark.parametrize("shape", SHAPES, ids=["1d", "2d", "3d", "4d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_stat_norm_matches_the_reference(dtype, shape):
    rng = np.random.default_rng(len(shape) + 10 * shape[-1])
    # features of other means and scales, so that the per-feature statistics matter
    x = rng.normal(size=shape) * rng.uniform(0.5, 4.0, size=shape[-1]) + rng.normal(
        size=shape[-1]) * 3
    (xj, xt) = _pair(x, dtype)
    (sj, st), (bj, bt) = (_pair(rng.normal(size=shape[-1]), dtype) for _ in range(2))
    want = jax_layers.batch_stat_norm(xj, sj, bj)
    got = layers.batch_stat_norm(xt, st, bt)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_batch_stat_norm_normalises_each_feature_over_the_leading_dims():
    """At scale 1 and bias 0 every feature has mean 0 and variance 1 over
    all rows of every leading dim, whatever their split."""
    x = torch.from_numpy(np.random.default_rng(1).normal(3.0, 5.0, size=(4, 9, 6)))
    y = layers.batch_stat_norm(x.float(), torch.ones(6), torch.zeros(6), eps=0.0)
    flat = y.reshape(-1, 6).double()
    torch.testing.assert_close(flat.mean(0), torch.zeros(6, dtype=torch.float64), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(flat.var(0, unbiased=False), torch.ones(6, dtype=torch.float64),
                               atol=1e-5, rtol=0)
    flat_in = layers.batch_stat_norm(x.float().reshape(36, 6), torch.ones(6), torch.zeros(6),
                                     eps=0.0)
    torch.testing.assert_close(flat_in, y.reshape(36, 6), atol=1e-6, rtol=1e-6)
