"""The port's fused ensemble adapter (plain version, CPU) against the JAX
Pallas kernel ``fused_ensemble_adapter(..., 0.5, True)`` (interpret mode):
forward and gradients, float32, tolerance rtol=1e-4, atol=1e-5; and the CUDA
kernel's arithmetic emulated in torch against the same kernel in bf16 (see
the section below)."""

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


# h's shape (the last axis is d) and the bottleneck r: the tiny cases, then
# bottlenecks past 128 (the CUDA kernel walks them in chunks) and widths past
# 1024 at the sizes the card runs them.
FORWARD_CASES = [
    pytest.param((2, 10, 32), 8, id="shape0"),
    pytest.param((3, 32), 8, id="shape1"),
    pytest.param((1, 300, 32), 8, id="shape2"),
    pytest.param((5, 768), 192, id="r192"),
    pytest.param((5, 768), 384, id="r384"),
    pytest.param((3, 1280), 80, id="d1280"),
    pytest.param((3, 2048), 128, id="d2048"),
]


@pytest.mark.parametrize("shape,r", FORWARD_CASES)
def test_forward_matches_jax_kernel(shape, r):
    rng = np.random.RandomState(len(shape) + shape[0])
    h = rng.randn(*shape).astype(np.float32)
    pa, pb = _params(rng, shape[-1], r), _params(rng, shape[-1], r)
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


# ---------------------------------------------------------------------------
# The arithmetic of the CUDA kernel (csrc/adapter_fused.cu), emulated in plain
# torch: the bottleneck walked in chunks of one width (at most 128 columns),
# for each chunk the down projection as four K-slice partials (one per CTA of
# the cluster) summed in rank order, bias and ReLU in fp32, the ReLU output
# split into bf16 parts, each adapter's up projection accumulated in fp32 from
# the bf16 x bf16 products of the parts (the small parts first), each chunk's
# sums added to the chunks' before; then the fp32 mix rounded once to bf16.
# Held against the JAX kernel in interpret mode within the chip's limit: one
# bf16 ulp, 2^-7 |ref| + 1e-6.

D_FULL, R_FULL = 768, 48


def _chunk_width(r):
    """The kernel's chunk width: as few chunks as take at most 128 columns,
    all of one width, a multiple of 16 (adapter_fused.cu::chunk_width)."""
    n = -(-r // 128)
    return -(-(-(-r // n)) // 16) * 16


def _emulate_kernel(h, params_a, params_b, weight, parts=3):
    bf, f32 = torch.bfloat16, torch.float32
    hf = h.to(f32)
    ks = h.shape[-1] // 4
    rc = _chunk_width(params_a[0].shape[1])

    def down(wd, bd):
        wdf = wd.to(f32)
        s = None
        for r in range(4):  # rank order, the same on every rank
            p = hf[:, r * ks:(r + 1) * ks] @ wdf[r * ks:(r + 1) * ks]
            s = p if s is None else s + p
        return torch.relu(s + bd.to(f32))

    def split(x):
        out, rest = [], x
        for _ in range(parts):
            piece = rest.to(bf).to(f32)
            out.append(piece)
            rest = rest - piece
        return out

    def branch(wd, bd, wu, bu):
        acc = None
        for c0 in range(0, wd.shape[1], rc):  # the chunks in order
            cols = slice(c0, c0 + rc)
            part = torch.zeros(h.shape[0], wu.shape[1], dtype=f32)
            for piece in reversed(split(down(wd[:, cols], bd[cols]))):  # lo, mid, hi
                part = part + piece @ wu[cols].to(f32)
            acc = part if acc is None else acc + part
        return acc + bu.to(f32)

    a, b = branch(*params_a), branch(*params_b)
    return (weight * a + (1.0 - weight) * b).to(bf)


def _bf16_case(rng, n, d, r):
    """bf16 inputs at the serving scales of chip_smoke.py, as torch tensors and
    as float32 numpy arrays holding the same bf16 values."""
    def t(*shape, std):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(torch.bfloat16)

    h = t(n, d, std=1.0)
    pa = (t(d, r, std=0.05), t(r, std=1.0), t(r, d, std=0.05), t(d, std=0.5))
    pb = (t(d, r, std=0.05), t(r, std=1.0), t(r, d, std=0.05), t(d, std=0.5))
    return h, pa, pb


def _jax_bf16(h, pa, pb, weight):
    def j(x):
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)

    out = jax_fused(j(h), tuple(map(j, pa)), tuple(map(j, pb)), weight, True)
    return np.asarray(out.astype(jnp.float32))


def _probe_case():
    """ReLU outputs with bits below a bf16 hi + lo pair: a's units 0 and 1 are
    1 + 2^-9 + 2^-18 and 1 + 2^-9, b's units 5 and 6 are 1 + 2^-9 + 3 2^-19
    and 1 + 2^-9 (exact in fp32, the three terms in three K slices); Wu rows
    +1 and -1 leave a = 2^-18 and b = 3 2^-19, a mix of 5 2^-20 at w = 0.5."""
    bf, d, r = torch.bfloat16, D_FULL, R_FULL
    h = torch.zeros(65, d, dtype=bf)
    h[:, [0, d // 4, d // 2]] = 1.0
    params = []
    for (u0, u1), low in (((0, 1), 2.0 ** -18), ((5, 6), 3 * 2.0 ** -19)):
        wd = torch.zeros(d, r, dtype=bf)
        wd[0, [u0, u1]] = 1.0
        wd[d // 4, [u0, u1]] = 2.0 ** -9
        wd[d // 2, u0] = low
        wu = torch.zeros(r, d, dtype=bf)
        wu[u0], wu[u1] = 1.0, -1.0
        params.append((wd, torch.zeros(r, dtype=bf), wu, torch.zeros(d, dtype=bf)))
    return h, params[0], params[1], 5 * 2.0 ** -20


def test_kernel_rounding_design_matches_jax_kernel_at_full_width():
    """At the serving bottleneck (one chunk) and at a DAT ensemble's
    reduction 4, R=192 (two chunks of 96, the up projection's sums carried
    from the first to the second)."""
    assert [_chunk_width(r) for r in (48, 128, 129, 192, 196, 384)] == [48, 128, 80, 96, 112, 128]
    for r, seed in ((R_FULL, 7), (192, 8)):
        rng = np.random.RandomState(seed)
        h, pa, pb = _bf16_case(rng, 300, D_FULL, r)
        want = _jax_bf16(h, pa, pb, 0.5)
        got = _emulate_kernel(h, pa, pb, 0.5).float().numpy()
        limit = 2.0 ** -7 * np.abs(want) + 1e-6
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= limit).all(), (r, np.abs(got - want).max())


@pytest.mark.parametrize("parts", [3, 2])
def test_kernel_rounding_design_low_bits_probe(parts):
    h, pa, pb, exact = _probe_case()
    want = _jax_bf16(h, pa, pb, 0.5)
    assert (want == exact).all()
    got = _emulate_kernel(h, pa, pb, 0.5, parts=parts).float().numpy()
    if parts == 3:  # hi + mid + lo carries the ReLU output exactly: bitwise the JAX kernel's
        np.testing.assert_array_equal(got, want)
    else:  # hi + lo drops 2^-18 and 3 2^-19: the probe reads 0
        assert (got == 0).all()
