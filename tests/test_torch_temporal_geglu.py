"""TPU rows 9 and 10 in the port, on the CPU: the frame-axis packed
attention (``fused_temporal_mha`` and its dispatch entry
``temporal_attention_packed``) and the GEGLU combine (``geglu``), each
against the JAX package's Pallas kernel run in interpret mode and its plain
reference, on the same numpy inputs in float32; both gradients against the
JAX custom VJPs; and the argument checks the CUDA kernels rely on.

Tolerances: float32 on both sides in another summation order (per block in
the Pallas interpret path, per GEMM in torch): 2e-5 absolute and relative
for O(1) values, as in ``test_torch_kernels.py``. GEGLU in bf16: one bf16
rounding of the output, so where the float32 values straddle a rounding
tie the two sides land one bf16 ulp apart (at most 2^-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.kernels.attention import _fused_temporal_bwd, _temporal_mha_ref
from t2v.kernels.attention import temporal_attention_packed as j_temporal_attention_packed
from t2v.kernels.fused_mha import fused_temporal_mha as j_fused_temporal_mha
from t2v.kernels.geglu import _geglu_bwd, _geglu_ref, geglu_pallas
from t2v_torch.kernels import attention as tatt
from t2v_torch.kernels import fused_mha as tfm
from t2v_torch.kernels import geglu as tgeglu
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, rows, n, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, n, hd)).astype(np.float32) for _ in range(3)]


# the shapes of the JAX package's own test: 24 frames of 8x8 tokens, 16
# frames of a non-power-of-two token count, an odd frame count, 125 frames
# (not a multiple of 8: the Pallas kernel pads), and a prime token count
TEMPORAL_SHAPES = [(2, 24, 64, 8, 64), (2, 16, 36, 4, 32), (1, 5, 128, 2, 16),
                   (1, 125, 16, 2, 16), (3, 8, 7, 2, 16)]


@pytest.mark.parametrize("b,f,n,heads,dh", TEMPORAL_SHAPES)
def test_temporal_plain_and_dispatch_match_pallas_interpret(b, f, n, heads, dh):
    q, k, v = _qkv(b * f + n, b * f, n, heads * dh)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(j_fused_temporal_mha(jq, jk, jv, heads=heads, f=f, interpret=True))
    ref = np.asarray(_temporal_mha_ref(jq, jk, jv, heads, f, None))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = tfm.fused_temporal_mha_plain(tq, tk, tv, heads, f).numpy()
    entry = tfm.fused_temporal_mha(tq, tk, tv, heads, f).numpy()
    dispatch = tatt.temporal_attention_packed(tq, tk, tv, heads, f).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_array_equal(entry, plain)
    np.testing.assert_allclose(dispatch, ref, **TOL)


def test_temporal_dispatch_matches_jax_dispatch_with_a_scale():
    q, k, v = _qkv(3, 2 * 6, 16, 4 * 16)
    want = j_temporal_attention_packed(*map(jnp.asarray, (q, k, v)), heads=4, f=6, scale=0.3)
    got = tatt.temporal_attention_packed(*map(torch.from_numpy, (q, k, v)), 4, 6, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_frame_axis_swap_round_trips_and_matches_jax():
    from t2v.kernels.attention import _swap_frame_axis, _unswap_frame_axis

    x = np.arange(2 * 3 * 5 * 4, dtype=np.float32).reshape(2 * 3, 5, 4)
    swapped = tatt._swap_frame_axis(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(swapped.numpy(), np.asarray(_swap_frame_axis(jnp.asarray(x), 3)))
    back = tatt._unswap_frame_axis(swapped, 5)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(_unswap_frame_axis(_swap_frame_axis(jnp.asarray(x), 3), 5)))


def test_temporal_function_gradient_matches_jax_custom_vjp():
    b, f, n, heads, dh = 2, 4, 6, 2, 16
    q, k, v = _qkv(9, b * f, n, heads * dh)
    g = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    want = _fused_temporal_bwd(heads, f, None, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tfm.FusedTemporalMHAFunction.apply(*leaves, heads, f, dh ** -0.5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)


def _proj(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# the JAX package's own shapes, and rows = 3 x 37 (no clean row block: the
# Pallas wrapper pads)
@pytest.mark.parametrize("shape", [(2, 64, 512), (48, 16, 256), (1, 8, 2560), (3, 37, 256)])
def test_geglu_plain_and_entry_match_pallas_interpret(shape):
    x = _proj(sum(shape), shape)
    want = np.asarray(geglu_pallas(jnp.asarray(x), interpret=True))
    ref = np.asarray(_geglu_ref(jnp.asarray(x)))
    plain = tgeglu.geglu_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_array_equal(tgeglu.geglu(torch.from_numpy(x)).numpy(), plain)


def test_geglu_bf16_rounds_once_like_the_pallas_kernel():
    x = _proj(1, (4, 32, 1024), 2.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(geglu_pallas(xb, interpret=True).astype(jnp.float32))
    got = tgeglu.geglu_plain(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    # the Pallas erf is a polynomial within 1.5e-7 of erf: the float32
    # values agree to a few ulps and their one bf16 rounding to one ulp;
    # where gelu(gate) is near 0 (gate below -4) that absolute 1.5e-7, times
    # |h * gate| / 2, leaves up to about 1.3e-6 between the two
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=2e-6)


def test_geglu_function_gradient_matches_jax_custom_vjp():
    x = _proj(2, (3, 5, 64))
    d = _proj(3, (3, 5, 32), 1.0)
    (want,) = _geglu_bwd(jnp.asarray(x), jnp.asarray(d))
    leaf = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tgeglu.GEGLUFunction.apply(leaf), leaf, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tgeglu.geglu_backward(torch.from_numpy(x), torch.from_numpy(d)),
                               np.asarray(want), **TOL)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("q,heads,f", [
    (torch.zeros(8, 6, 128), 2, 4),              # float32
    (_bf16(8, 6, 64), 2, 4),                     # head dim 32
    (_bf16(8, 128, 6).transpose(1, 2), 2, 4),    # not contiguous
    (_bf16(9, 6, 128), 2, 4),                    # rows not whole samples of f frames
    (_bf16(512, 2, 128), 2, 512),                # frame axis too long for the kernel
    (_bf16(8, 128), 2, 4),                       # 2-D
])
def test_fused_temporal_mha_refuses(q, heads, f):
    with pytest.raises(ValueError):
        tfm.check_temporal_args(q, q, q, heads, f)
    tfm.check_temporal_args(_bf16(8, 6, 128), _bf16(8, 6, 128), _bf16(8, 6, 128), 2, 4)


@pytest.mark.parametrize("proj", [
    torch.zeros(4, 32),                  # float32
    _bf16(32, 4).transpose(0, 1),        # not contiguous
    _bf16(4, 24),                        # inner 12 is not a multiple of 8
    _bf16(4, 33),                        # no even split
    _bf16(4, 0),                         # empty
])
def test_geglu_refuses(proj):
    with pytest.raises(ValueError):
        tgeglu.check_args(proj)
    tgeglu.check_args(_bf16(4, 32))


def test_cpu_tensors_launch_nothing():
    before = (tfm.TEMPORAL_COUNTER.count, tgeglu.COUNTER.count)
    q = torch.randn(4, 3, 32, requires_grad=True)
    tatt.temporal_attention_packed(q, q, q, 2, 2).sum().backward()
    tgeglu.geglu(torch.randn(3, 16, requires_grad=True)).sum().backward()
    assert q.grad is not None and (tfm.TEMPORAL_COUNTER.count, tgeglu.COUNTER.count) == before
