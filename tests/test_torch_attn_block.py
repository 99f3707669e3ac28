"""The port's plain attention-block versions against the JAX Pallas kernels
(``ops/attn_block.py``, interpret mode) on the CPU in float32: the forward's
out, ctx and lse (``_fwd_call``), and the backward's dx (kernel #3 through the
custom_vjp, ``jax.vjp``), with and without the fused LayerNorm, with S padded
to the kernel's multiple of 16 and an odd batch.  Tolerance rtol=1e-4,
atol=1e-5 (tests/test_pallas_kernels.py): one fp32 function, summed in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddat_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from feddat_tpu.ops.attn_block import _fwd_call
from feddat_tpu.ops.attn_block import attn_block as jax_attn_block
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
@pytest.mark.parametrize("b,s", [(2, 16), (3, 21), (3, 17), (1, 127), (1, 129), (1, 769), (1, 1030)])
def test_reference_matches_jax_kernel(b, s, fuse_ln):
    """B=1 at S=127 and 129 mirrors the card's row counts on either side of
    the GEMM's 128-row tile; S=769 and 1030 lie past the 768 keys that #1's
    first CUDA core held in shared memory (JAX's kernel has no such cap)."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 127), (1, 129), (3, 21)])
def test_ln1_plane_outside_equals_fused_forward(b, s, dtype):
    """The CUDA forward of #1 writes bf16(LN1(x)) once as a plane and runs
    its q|k|v product on that plane with no LayerNorm of its own (the launches
    of #3's recompute).  In plain ops that route (the plane, then the forward
    without LN) gives the fused-LN plain forward exactly, and in fp32 both
    agree with the JAX kernel."""
    inp = _inputs(b * 37 + s, b, s)
    heads, eps, scale = 4, 1e-12, 8 ** -0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    x = t(inp["x"]).to(dtype)
    ws = [t(w.T).to(dtype) for w in inp["ws"]]
    bqkv, bo, gb = t(inp["bqkv"]), t(inp["bo"]), t(inp["gb"])
    bias = mask_to_bias(t(inp["mask"]))
    fused = ab.attn_block_reference(x, *ws, bqkv, bo, gb, bias, heads, scale, eps)
    plane = ab.layer_norm_fast_variance(x, gb[0], gb[1], eps).to(dtype)
    outside = ab.attn_block_reference(plane, *ws, bqkv, bo, None, bias, heads, scale, None)
    for got, want in zip(outside, fused):
        assert torch.equal(got, want)
    if dtype == torch.float32:
        out_j, (_, _, ctx_j, lse_j) = _fwd_call(
            jnp.asarray(inp["x"]), *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
            jnp.asarray(inp["bo"]), jnp.asarray(inp["gb"]), jax_mask_to_bias(jnp.asarray(inp["mask"])),
            heads, scale, 1, True, eps,
        )
        for got, want in zip(outside, (out_j, np.asarray(ctx_j)[:b, :s], np.asarray(lse_j)[:b, :, :s])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("fuse_ln", [False, True])
@pytest.mark.parametrize("b,s", [(2, 16), (3, 21), (1, 127), (1, 129), (1, 769), (1, 1030)])
def test_backward_dx_matches_jax_vjp(b, s, fuse_ln):
    """Kernel #3's plain version through the port's autograd wrapper: dx
    real, every other input without a gradient (the JAX contract returns
    zeros there, attn_block.py:416-419).  B=1 at S=127 and 129 mirrors the
    card's row counts on either side of the GEMM's 128-row tile; S=769 and
    1030 lie past the 768 keys of #3's first CUDA core (with LN1 fused, JAX
    takes it outside the kernel there, and so does the port)."""
    inp = _inputs(b * 10 + s + 7, b, s)
    heads, eps = 4, 1e-12
    gb = inp["gb"] if fuse_ln else None
    ln_eps = eps if fuse_ln else None
    g = np.random.RandomState(s).randn(b, s, 32).astype(np.float32)
    bias_j = jax_mask_to_bias(jnp.asarray(inp["mask"]))

    def f(x):
        return jax_attn_block(x, *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
                              jnp.asarray(inp["bo"]), None if gb is None else jnp.asarray(gb),
                              bias_j, heads, None, 1, True, ln_eps)

    _, vjp = jax.vjp(f, jnp.asarray(inp["x"]))
    (want,) = vjp(jnp.asarray(g))
    x = torch.tensor(inp["x"], requires_grad=True)
    ws = [torch.tensor(np.ascontiguousarray(w.T), requires_grad=True) for w in inp["ws"]]
    out = ab.attn_block(x, *ws, torch.tensor(inp["bqkv"]), torch.tensor(inp["bo"]),
                        None if gb is None else torch.tensor(gb),
                        mask_to_bias(torch.tensor(inp["mask"])), heads, None, ln_eps)
    got = torch.autograd.grad(out, [x, *ws], torch.from_numpy(g), allow_unused=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert all(t is None for t in got[1:])


def test_backward_past_448_takes_the_layernorm_outside():
    """At S=450 (padded 464 > LN_BWD_FUSED_MAX_S) JAX recomputes LN1
    outside the kernel and converts the kernel's dx back through it; the
    port follows the same split (attn_block.py:372-415)."""
    b, s = 1, 450
    inp = _inputs(11, b, s)
    g = np.random.RandomState(12).randn(b, s, 32).astype(np.float32)
    bias_j = jax_mask_to_bias(jnp.asarray(inp["mask"]))

    def f(x):
        return jax_attn_block(x, *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
                              jnp.asarray(inp["bo"]), jnp.asarray(inp["gb"]), bias_j, 4, None,
                              1, True, 1e-12)

    _, vjp = jax.vjp(f, jnp.asarray(inp["x"]))
    (want,) = vjp(jnp.asarray(g))
    x = torch.tensor(inp["x"], requires_grad=True)
    out = ab.attn_block(x, *(torch.tensor(np.ascontiguousarray(w.T)) for w in inp["ws"]),
                        torch.tensor(inp["bqkv"]), torch.tensor(inp["bo"]), torch.tensor(inp["gb"]),
                        mask_to_bias(torch.tensor(inp["mask"])), 4, None, 1e-12)
    (got,) = torch.autograd.grad(out, [x], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 127), (1, 129), (3, 21)])
def test_ln1_plane_outside_equals_fused_backward(b, s, dtype):
    """The CUDA backward of #3 (and #4's attention part) writes bf16(LN1(x))
    once as a plane, feeds it to the attention core as a plain input, and
    takes dxln back through LN1.  In plain ops that route (the plane, the
    core with no LayerNorm, LN1's backward outside) gives the fused-LN plain
    backward exactly, and both agree with jax.vjp of the JAX kernel in fp32."""
    inp = _inputs(b * 31 + s, b, s)
    heads, eps, scale = 4, 1e-12, 8 ** -0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    x = t(inp["x"]).to(dtype)
    ws = [t(w.T).to(dtype) for w in inp["ws"]]
    bqkv, bo, gb = t(inp["bqkv"]), t(inp["bo"]), t(inp["gb"])
    bias = mask_to_bias(t(inp["mask"]))
    _, ctx, lse = ab.attn_block_reference(x, *ws, bqkv, bo, gb, bias, heads, scale, eps)
    g = t(np.random.RandomState(s + 1).randn(b, s, 32).astype(np.float32)).to(dtype)
    fused = ab.attn_block_bwd_reference(x, *ws, bqkv, gb, bias, ctx, lse, g, heads, scale, eps)

    plane = ab.layer_norm_fast_variance(x, gb[0], gb[1], eps).to(dtype)
    xhat, rstd = ab.layer_norm_stats(x, eps)
    dxln = ab.attn_bwd_core_reference(plane, *ws, bqkv, ab._key_bias(bias, b, s), ctx, lse, g,
                                      heads, scale)
    outside = ab.layer_norm_bwd(dxln, xhat, rstd, gb[0]).to(dtype)
    assert torch.equal(outside, fused)
    if dtype == torch.float32:
        def f(x_):
            return jax_attn_block(x_, *map(jnp.asarray, inp["ws"]), jnp.asarray(inp["bqkv"]),
                                  jnp.asarray(inp["bo"]), jnp.asarray(inp["gb"]),
                                  jax_mask_to_bias(jnp.asarray(inp["mask"])), heads, scale, 1, True, eps)

        _, vjp = jax.vjp(f, jnp.asarray(inp["x"]))
        (want,) = vjp(jnp.asarray(g.numpy()))
        np.testing.assert_allclose(outside.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
