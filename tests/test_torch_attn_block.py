"""The port's plain attention-block version against the JAX Pallas kernel
(``ops/attn_block.py::_fwd_call``, interpret mode) on the CPU in float32:
out, ctx and lse, with and without the fused LayerNorm, with S padded to the
kernel's multiple of 16 and an odd batch.  Tolerance rtol=1e-4, atol=1e-5
(tests/test_pallas_kernels.py): one fp32 function, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from feddat_tpu.ops.attn_block import _fwd_call
from feddat_tpu_torch.ops import attn_block as ab
from feddat_tpu_torch.ops.attention import mask_to_bias

RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, b, s, dm=32):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(b, s, dm) * 0.5 + 0.1).astype(np.float32),
        ws=[(rng.randn(dm, dm) * 0.05).astype(np.float32) for _ in range(4)],  # flax [in, out]
        bqkv=(rng.randn(3, dm) * 0.02).astype(np.float32),
        bo=(rng.randn(1, dm) * 0.02).astype(np.float32),
        gb=np.stack([1.0 + 0.1 * rng.randn(dm), 0.1 * rng.randn(dm)]).astype(np.float32),
        mask=(rng.rand(b, s) > 0.25).astype(np.int32),
    )


@pytest.mark.parametrize("fuse_ln", [False, True])
@pytest.mark.parametrize("b,s", [(2, 16), (3, 21), (3, 17)])
def test_reference_matches_jax_kernel(b, s, fuse_ln):
    inp = _inputs(b * 100 + s, b, s)
    heads, eps = 4, 1e-12
    gb = inp["gb"] if fuse_ln else None
    ln_eps = eps if fuse_ln else None
    out_j, (_, _, ctx_j, lse_j) = _fwd_call(
        jnp.asarray(inp["x"]), *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
        jnp.asarray(inp["bo"]), None if gb is None else jnp.asarray(gb),
        jax_mask_to_bias(jnp.asarray(inp["mask"])), heads, 8 ** -0.5, 1, True, ln_eps,
    )
    t = torch.from_numpy
    out, ctx, lse = ab.attn_block_reference(
        t(inp["x"]), *(t(np.ascontiguousarray(w.T)) for w in inp["ws"]), t(inp["bqkv"]),
        t(inp["bo"]), None if gb is None else t(gb), mask_to_bias(t(inp["mask"])),
        heads, 8 ** -0.5, ln_eps,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j)[:b, :s], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:b, :, :s], rtol=RTOL, atol=ATOL)


def test_dispatch_on_cpu_is_the_plain_version():
    inp = _inputs(5, 2, 9)
    t = torch.from_numpy
    args = (t(inp["x"]), *(t(np.ascontiguousarray(w.T)) for w in inp["ws"]), t(inp["bqkv"]),
            t(inp["bo"]), t(inp["gb"]), mask_to_bias(t(inp["mask"]))[:1], 4, None, 1e-5)
    before = ab.KERNEL.launches
    out = ab.attn_block(*args)
    assert ab.KERNEL.launches == before  # the CPU path launches no kernel
    # a batch-broadcast [1, 1, 1, S] bias expands like the JAX _prep does
    np.testing.assert_array_equal(out.numpy(), ab.attn_block_reference(*args)[0].numpy())
    with pytest.raises(ValueError, match="padding bias"):
        ab.attn_block(*args[:8], torch.zeros(2, 1, 9, 9), 4)
