"""The port's VideoCrafter kernel modules on the CPU: each wrapper's plain
PyTorch version against the JAX package's Pallas kernel run in interpret
mode and its plain reference, on the same numpy inputs, in float32 with
TF32 off (the CPU has none).

Tolerance: rtol = atol = 2e-4. Both sides run the same float32 arithmetic
in another summation order (the Pallas interpret path accumulates per
block, torch per GEMM), so agreement is to float32 rounding of O(1) values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.kernels.attention import _cross_mha_ref
from t2v.kernels.attention import cross_attention_packed as j_cross_attention_packed
from t2v.kernels.flash_attention import flash_attention as j_flash
from t2v.kernels.fused_mha import fused_cross_mha as j_fused_cross_mha
from t2v.kernels.fused_mha import fused_self_mha as j_fused_self_mha
from t2v.kernels.relpos_mha import fused_relpos_temporal_mha, relpos_ref
from t2v_torch.kernels import attention as tatt
from t2v_torch.kernels.flash_attention import flash_attention
from t2v_torch.kernels.fused_mha import fused_cross_mha, fused_cross_mha_plain, fused_self_mha
from t2v_torch.kernels.relpos_mha import relpos_mha, relpos_mha_plain
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# (samples, frames, tokens, heads, head dim): the VideoCrafter head widths at
# 16 frames, a ragged frame count, and a single-token one (the (B', T, C)
# layout of the default contract)
@pytest.mark.parametrize("bb,t,n,heads,dh", [(2, 16, 8, 2, 40), (1, 16, 16, 2, 80),
                                             (1, 16, 8, 1, 160), (2, 5, 16, 3, 8),
                                             (3, 4, 1, 2, 8)])
def test_relpos_plain_matches_reference_and_pallas_interpret(bb, t, n, heads, dh):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, bb * t, n, heads * dh) for _ in range(3))
    k2, v2 = (0.5 * _normal(rng, t, t, dh) for _ in range(2))
    scale = dh ** -0.5
    jq, jk, jv, jk2, jv2 = map(jnp.asarray, (q, k, v, k2, v2))
    ref = np.asarray(relpos_ref(jq, jk, jv, jk2, jv2, heads, t, scale))
    pallas = np.asarray(fused_relpos_temporal_mha(jq, jk, jv, jk2, jv2, heads=heads,
                                                  frame_split=t, scale=scale, interpret=True))
    plain = relpos_mha_plain(_t(q), _t(k), _t(v), _t(k2), _t(v2), heads, t, scale).numpy()
    wrapped = relpos_mha(_t(q), _t(k), _t(v), _t(k2), _t(v2), heads, t).numpy()
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(plain, pallas, **TOL)
    np.testing.assert_array_equal(wrapped, plain)


def test_relpos_zero_tables_is_plain_temporal_attention():
    rng = np.random.default_rng(1)
    bb, t, n, heads, dh = 2, 6, 4, 2, 8
    q, k, v = (_t(_normal(rng, bb * t, n, heads * dh)) for _ in range(3))
    zero = torch.zeros(t, t, dh)
    got = relpos_mha(q, k, v, zero, zero, heads, t)
    swap = lambda z: z.reshape(bb, t, n, heads * dh).transpose(1, 2).reshape(bb * n, t, heads * dh)
    want = fused_self_mha(swap(q), swap(k), swap(v), heads)
    want = want.reshape(bb, n, t, heads * dh).transpose(1, 2).reshape(bb * t, n, heads * dh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# many query rows over a 77-token context at the VideoCrafter head widths,
# a ragged row count, and a context that is no multiple of 16
@pytest.mark.parametrize("b,n,s,heads,dh", [(2, 256, 77, 2, 40), (1, 128, 77, 2, 80),
                                            (1, 64, 77, 1, 160), (3, 104, 50, 5, 8)])
def test_fused_cross_mha_plain_matches_pallas_interpret(b, n, s, heads, dh):
    rng = np.random.default_rng(2)
    q = _normal(rng, b, n, heads * dh)
    k, v = (_normal(rng, b, s, heads * dh) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(j_fused_cross_mha(jq, jk, jv, heads=heads, interpret=True))
    ref = np.asarray(_cross_mha_ref(jq, jk, jv, heads, dh ** -0.5))
    plain = fused_cross_mha_plain(_t(q), _t(k), _t(v), heads).numpy()
    wrapped = fused_cross_mha(_t(q), _t(k), _t(v), heads).numpy()
    np.testing.assert_allclose(plain, pallas, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("s", [77, 600])
def test_cross_dispatch_matches_jax(s):
    rng = np.random.default_rng(3)
    q = _normal(rng, 2, 96, 2 * 40)
    k, v = (_normal(rng, 2, s, 2 * 40) for _ in range(2))
    want = np.asarray(j_cross_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2))
    got = tatt.cross_attention_packed(_t(q), _t(k), _t(v), 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dh", [40, 80, 160])
def test_fused_self_mha_plain_at_videocrafter_head_dims(dh):
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, 3, 24, 2 * dh) for _ in range(3))
    want = np.asarray(j_fused_self_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads=2, interpret=True))
    got = fused_self_mha(_t(q), _t(k), _t(v), 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ragged S (no multiple of the 128 block); the JAX dispatch sends any head dim
# that is a multiple of 8 to flash
@pytest.mark.parametrize("dh", [40, 80, 160])
def test_flash_plain_at_videocrafter_head_dims(dh):
    rng = np.random.default_rng(5)
    q = _normal(rng, 2, 72, dh)
    k, v = (_normal(rng, 2, 200, dh) for _ in range(2))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=128, block_kv=128, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
