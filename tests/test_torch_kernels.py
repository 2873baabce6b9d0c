"""The port's kernel modules on the CPU: each wrapper's plain PyTorch
version against the JAX package's Pallas kernel run in interpret mode
(and its plain reference), on the same numpy inputs, in float32.

Tolerances: both sides run the same float32 arithmetic in another
summation order (the Pallas interpret path accumulates per block, torch
per GEMM), so agreement is to float32 rounding of O(1) values: 2e-5
absolute and relative unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.kernels import temporal_conv as jtc
from t2v.kernels.attention import attention_mh as j_attention_mh
from t2v.kernels.attention import self_attention_packed as j_self_attention_packed
from t2v.kernels.flash_attention import flash_attention as j_flash
from t2v.kernels.fused_mha import fused_self_mha as j_fused_self_mha
from t2v_torch.kernels import attention as tatt
from t2v_torch.kernels import temporal_conv as ttc
from t2v_torch.kernels.flash_attention import flash_attention
from t2v_torch.kernels.fused_mha import fused_self_mha

TOL = dict(rtol=2e-5, atol=2e-5)


def _chain_inputs(seed, b, f, hw, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, f, hw, c)).astype(np.float32)
    layers = []
    for i in range(4):
        layers.append((
            (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
            (0.1 * rng.normal(size=(c,))).astype(np.float32),
            (rng.normal(size=(3, c, c)) / np.sqrt(3 * c)).astype(np.float32),
            (0.1 * rng.normal(size=(c,))).astype(np.float32),
        ))
    return x, layers


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# frame counts 8 and 5 (not a multiple of 8), widths 64 and 128
@pytest.mark.parametrize("b,f,hw,c", [(2, 8, 16, 64), (1, 5, 12, 128)])
def test_temporal_conv_chain_matches_pallas_interpret(b, f, hw, c):
    x, layers = _chain_inputs(0, b, f, hw, c)
    want = np.asarray(jtc.temporal_conv_chain(
        jnp.asarray(x), [tuple(map(jnp.asarray, l)) for l in layers], interpret=True))
    ref = np.asarray(jtc.chain_ref(jnp.asarray(x), [tuple(map(jnp.asarray, l)) for l in layers]))
    t_layers = [tuple(map(_t, l)) for l in layers]
    got = ttc.temporal_conv_chain(_t(x), t_layers).numpy()
    plain = ttc.chain_plain(_t(x), t_layers).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(plain, ref, **TOL)


def test_temporal_conv_layer_emits_next_layer_stats():
    x, layers = _chain_inputs(1, 2, 6, 8, 64)
    xt = _t(x)
    fin = ttc.finalize_stats(ttc.input_stats(xt), 6 * 8, 1e-5)
    y, raw = ttc.temporal_conv_layer(xt, fin, *map(_t, layers[0]))
    np.testing.assert_allclose(raw.numpy(), ttc.input_stats(y).numpy(), rtol=1e-6, atol=1e-6)
    want = np.asarray(jtc.finalize_stats(jtc.input_stats(jnp.asarray(x)), 48, 1e-5))
    np.testing.assert_allclose(fin.numpy(), want, **TOL)


def test_temporal_conv_zero_last_conv_is_identity():
    x, layers = _chain_inputs(2, 1, 4, 8, 64)
    layers[3] = (layers[3][0], layers[3][1], np.zeros_like(layers[3][2]), np.zeros_like(layers[3][3]))
    got = ttc.temporal_conv_chain(_t(x), [tuple(map(_t, l)) for l in layers]).numpy()
    np.testing.assert_array_equal(got, x)


def _qkv(seed, b, n, s, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, d)).astype(np.float32),
            rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(b, s, d)).astype(np.float32))


# ragged S (not a multiple of the 128 block) and a non-power-of-two scale
# (applied to the scores, not folded into q)
@pytest.mark.parametrize("n,s,d,scale", [(64, 200, 64, None), (100, 130, 32, 0.1),
                                         (40, 300, 64, 512 ** -0.5)])
def test_flash_plain_matches_pallas_interpret(n, s, d, scale):
    q, k, v = _qkv(3, 2, n, s, d)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                              block_q=128, block_kv=128, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# N = 24 frames (the UNet's temporal attention) and a ragged N = 13
@pytest.mark.parametrize("b,n,heads,dh", [(4, 24, 2, 64), (3, 13, 5, 64), (2, 24, 8, 16)])
def test_fused_self_mha_plain_matches_pallas_interpret(b, n, heads, dh):
    q, k, v = _qkv(4, b, n, n, heads * dh)
    want = np.asarray(j_fused_self_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads=heads, interpret=True))
    got = fused_self_mha(_t(q), _t(k), _t(v), heads).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [16, 600])
def test_packed_dispatch_matches_jax(n):
    q, k, v = _qkv(5, 2, n, n, 2 * 16)
    want = np.asarray(j_self_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2))
    got = tatt.self_attention_packed(_t(q), _t(k), _t(v), 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cross_attention_dispatch_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 50, 2, 16)).astype(np.float32)
    k = rng.normal(size=(3, 77, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 77, 2, 16)).astype(np.float32)
    want = np.asarray(j_attention_mh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tatt.attention_mh(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
