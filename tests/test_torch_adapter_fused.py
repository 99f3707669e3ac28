"""The port's fused ensemble adapter (plain version, CPU) against the JAX
Pallas kernel ``fused_ensemble_adapter(..., 0.5, True)`` (interpret mode):
forward and gradients, float32.  Tolerance rtol=1e-4, atol=1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops.adapter_fused import fused_ensemble_adapter as jax_fused
from feddat_tpu_torch.ops import adapter_fused as af

RTOL, ATOL = 1e-4, 1e-5


def _params(rng, d=32, r=8):
    return [(rng.randn(*shape) * 0.1).astype(np.float32) for shape in ((d, r), (r,), (r, d), (d,))]


@pytest.mark.parametrize("shape", [(2, 10, 32), (3, 32), (1, 300, 32)])
def test_forward_matches_jax_kernel(shape):
    rng = np.random.RandomState(len(shape) + shape[0])
    h = rng.randn(*shape).astype(np.float32)
    pa, pb = _params(rng), _params(rng)
    want = jax_fused(jnp.asarray(h), tuple(map(jnp.asarray, pa)), tuple(map(jnp.asarray, pb)),
                     0.5, True)
    got = af.fused_ensemble_adapter(torch.from_numpy(h), [torch.from_numpy(p) for p in pa],
                                    [torch.from_numpy(p) for p in pb], 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    ref = af.adapter_fused_reference(torch.from_numpy(h), [torch.from_numpy(p) for p in pa],
                                     [torch.from_numpy(p) for p in pb], 0.5)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_gradients_match_jax():
    rng = np.random.RandomState(4)
    h = rng.randn(3, 7, 32).astype(np.float32)
    pa, pb = _params(rng), _params(rng)
    gj = jax.grad(
        lambda h, a, b: jnp.sum(jax_fused(h, a, b, 0.5, True) ** 2), argnums=(0, 1, 2)
    )(jnp.asarray(h), tuple(map(jnp.asarray, pa)), tuple(map(jnp.asarray, pb)))
    th = torch.tensor(h, requires_grad=True)
    ta = [torch.tensor(p, requires_grad=True) for p in pa]
    tb = [torch.tensor(p, requires_grad=True) for p in pb]
    (af.fused_ensemble_adapter(th, ta, tb, 0.5) ** 2).sum().backward()
    got = [th.grad, *(t.grad for t in ta), *(t.grad for t in tb)]
    want = jax.tree_util.tree_leaves(gj)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
