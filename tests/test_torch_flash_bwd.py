"""The port's flash-attention backward and the gradients of its five
kernel ``autograd.Function``s, in fp32 on the CPU, against the JAX package.

* ``flash_attention_fwd_plain`` (its lse) and ``flash_attention_bwd_plain``
  against the Pallas ``flash_attention_fwd`` / ``flash_attention_bwd`` in
  interpret mode, at D = 40, 64, 80 and ragged N != S: atol 2e-5 (float32
  on both sides, another summation order; gradients of O(1) inputs are
  O(0.1));
* the same backward against autograd through ``flash_attention_plain``;
* the two CUDA backward kernels' tile loops modelled in float32 (the
  transposed S^T / dP^T tiles of dkv with lse and delta by column, tiles
  zero-filled past N, S and d as TMA fills them, lse and delta 0 past N,
  dq's ragged last key tile masked) against the plain halves at ragged
  shapes, one sample of which has lse so negative that exp(-lse)
  overflows: rtol = atol = 1e-5 (float32 on both sides in another
  summation order; that sample's gradients reach O(10));
* each Function's gradients (on the CPU its forward is the plain version,
  its backward the code the card runs after the kernel forward) against the
  JAX package's own backward of the matching entry: atol 2e-5 for the
  attention ones, atol = rtol = 1e-3 for the four-layer conv chain (the
  tolerance the JAX package's own chain-gradient test uses).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.kernels.attention import _fused_cross_bwd, _fused_self_bwd, xla_attention
from t2v.kernels.flash_attention import flash_attention_bwd as j_flash_bwd
from t2v.kernels.flash_attention import flash_attention_fwd as j_flash_fwd
from t2v.kernels.relpos_mha import _relpos_bwd
from t2v.kernels.temporal_conv import temporal_conv_chain as j_temporal_conv_chain
from t2v_torch.kernels import flash_attention as tflash
from t2v_torch.kernels import fused_mha as tfused
from t2v_torch.kernels import relpos_mha as trelpos
from t2v_torch.kernels import temporal_conv as ttc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
# (B, N, S, D, scale)
CASES = [(2, 128, 128, 64, None), (2, 96, 160, 40, None), (1, 72, 200, 80, 0.07),
         (3, 50, 130, 64, 0.125)]


def _qkvg(case, seed=0):
    b, n, s, d, _ = case
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return f(b, n, d), f(b, s, d), f(b, s, d), f(b, n, d)


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}n{c[1]}s{c[2]}d{c[3]}")
def test_forward_lse_matches_pallas_interpret(case):
    q, k, v, _ = _qkvg(case)
    scale = case[4]
    want_o, want_lse = j_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, block_q=128, block_kv=128,
        interpret=True)
    got_o, got_lse = tflash.flash_attention_fwd(*_t(q, k, v), scale)
    assert got_lse.shape == q.shape[:2] and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}n{c[1]}s{c[2]}d{c[3]}")
def test_backward_plain_matches_pallas_interpret(case):
    q, k, v, g = _qkvg(case, 1)
    scale = case[4]
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = j_flash_fwd(jq, jk, jv, scale=scale, block_q=128, block_kv=128,
                                        interpret=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jg, scale=scale, block_q=128,
                                      block_kv=128, interpret=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    to, tlse = tflash.flash_attention_fwd_plain(tq, tk, tv, scale)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, to, tlse, tg, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)
    # the dispatching entry and its halves run the same code on a CPU tensor
    again = tflash.flash_attention_bwd(tq, tk, tv, to, tlse, tg, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c[0]}n{c[1]}s{c[2]}d{c[3]}")
def test_backward_plain_matches_autograd_of_plain_forward(case):
    q, k, v, g = _qkvg(case, 2)
    scale = case[4]
    tq, tk, tv = _t(q, k, v, grad=True)
    (tg,) = _t(g)
    want = torch.autograd.grad(tflash.flash_attention_plain(tq, tk, tv, scale), (tq, tk, tv), tg)
    got = torch.autograd.grad(tflash.FlashAttentionFunction.apply(tq, tk, tv, scale or
                                                                  q.shape[-1] ** -0.5),
                              (tq, tk, tv), tg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, err_msg=name)


def test_flash_function_matches_jax_grad_and_takes_strided_gradients():
    case = (2, 64, 96, 40, None)
    q, k, v, g = _qkvg(case, 3)
    want = jax.vjp(lambda a, b, c: xla_attention(a, b, c), *map(jnp.asarray, (q, k, v)))[1](
        jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tflash.FlashAttentionFunction.apply(tq, tk, tv, 40 ** -0.5)
    # a gradient that arrives through a transposed view, as through the head fold
    strided = torch.tensor(np.ascontiguousarray(g.transpose(1, 0, 2))).transpose(0, 1)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(out, (tq, tk, tv), strided)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_backward_refuses_the_vae_head_dim_by_name():
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    f32 = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="512"):
        tflash.check_bwd_args(bf(2, 8, 512), bf(2, 8, 512), bf(2, 8, 512), bf(2, 8, 512), f32, f32)
    tflash.check_bwd_args(bf(2, 8, 64), bf(2, 9, 64), bf(2, 9, 64), bf(2, 8, 64), f32, f32)
    for bad in (dict(lse=torch.zeros(2, 9)), dict(do=bf(2, 8, 64).float()),
                dict(delta=torch.zeros(2, 8, dtype=torch.float64))):
        args = dict(q=bf(2, 8, 64), k=bf(2, 9, 64), v=bf(2, 9, 64), do=bf(2, 8, 64), lse=f32,
                    delta=f32)
        args.update(bad)
        with pytest.raises(ValueError):
            tflash.check_bwd_args(**args)


def _tma_tile(x, row0, rows, width):
    """Rows row0..row0 + rows of x (R, d) as a TMA box loads them: zeros past
    R and in the columns d..width."""
    out = torch.zeros(rows, width)
    part = x[row0:row0 + rows]
    out[:part.shape[0], :x.shape[1]] = part
    return out


def _rows(a, row0, count):
    """``count`` values of the row vector a from ``row0``, zeros past its
    end: a tile's lse or delta as the kernels load them."""
    out = torch.zeros(count)
    part = a[row0:row0 + count]
    out[:part.numel()] = part
    return out


def _dkv_model(q, k, v, do, lse, delta, scale):
    """The dkv kernel's loop: per (sample, key tile) S^T = K Q^T and
    dP^T = V dO^T over streamed query tiles, P^T and dS^T with lse and
    delta by column, dV += P^T dO, dK += dS^T Q. No mask: a query past N
    has zero q and dO and lse = delta = 0, so p = 1 and ds = 0."""
    b, n, d = q.shape
    s = k.shape[1]
    plan = tflash.flash_bwd_plan(b, n, s, d)
    bkv, bq, width = plan.dkv_bkv, plan.dkv_bq, 64 * math.ceil(d / 64)
    dk, dv = torch.zeros(b, s, d), torch.zeros(b, s, d)
    for bh in range(b):
        for kv0 in range(0, s, bkv):
            kt, vt = (_tma_tile(t[bh], kv0, bkv, width) for t in (k, v))
            acc_k, acc_v = torch.zeros(bkv, width), torch.zeros(bkv, width)
            for q0 in range(0, n, bq):
                qt, dot = (_tma_tile(t[bh], q0, bq, width) for t in (q, do))
                l, dl = (_rows(t[bh], q0, bq) for t in (lse, delta))
                pt = torch.exp((kt @ qt.T) * scale - l[None, :])
                dst = pt * ((vt @ dot.T) - dl[None, :]) * scale
                acc_v += pt.to(q.dtype).float() @ dot
                acc_k += dst.to(q.dtype).float() @ qt
            rows = min(bkv, s - kv0)
            dk[bh, kv0:kv0 + rows] = acc_k[:rows, :d]
            dv[bh, kv0:kv0 + rows] = acc_v[:rows, :d]
    return dk, dv


def _dq_model(q, k, v, do, lse, delta, scale, mask=True):
    """The dq kernel's loop: per (sample, query tile) S = Q K^T and
    dP = dO V^T over streamed key tiles, dS with each row's lse and delta
    (0 and 0 past N), dQ += dS K; the ragged last key tile masked (unless
    ``mask`` is False)."""
    b, n, d = q.shape
    s = k.shape[1]
    plan = tflash.flash_bwd_plan(b, n, s, d)
    bq, bkv, width = plan.dq_bq, plan.dq_bkv, 64 * math.ceil(d / 64)
    dq = torch.zeros(b, n, d)
    for bh in range(b):
        for q0 in range(0, n, bq):
            qt, dot = (_tma_tile(t[bh], q0, bq, width) for t in (q, do))
            rows = min(bq, n - q0)
            l, dl = (_rows(t[bh], q0, bq) for t in (lse, delta))
            acc = torch.zeros(bq, width)
            for kv0 in range(0, s, bkv):
                kt, vt = (_tma_tile(t[bh], kv0, bkv, width) for t in (k, v))
                p = torch.exp((qt @ kt.T) * scale - l[:, None])
                ds = p * ((dot @ vt.T) - dl[:, None]) * scale
                if mask and s - kv0 < bkv:
                    ds[:, s - kv0:] = 0.0
                acc += ds.to(q.dtype).float() @ kt
            dq[bh, q0:q0 + rows] = acc[:rows, :d]
    return dq


# (B, N, S, D): N and S off every tile at D = 40 (128-key dkv blocks), 80
# (the dV / dK split's 64-key blocks) and 160 (three column boxes), S under
# one key tile, a single query row
MODEL_CASES = [(3, 70, 150, 40), (3, 130, 30, 80), (3, 1, 65, 160)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: f"b{c[0]}n{c[1]}s{c[2]}d{c[3]}")
def test_kernel_tile_loops_match_the_plain_halves(case):
    """The edge argument of ``csrc/flash_attention_bwd.cu`` before any chip
    time: rows and columns that TMA zero-fills contribute nothing, and dq's
    mask of the ragged last key tile keeps exp(-lse) of a zero-filled key
    from overflowing into a 0 * inf. Sample 1's scores are all about -190
    (q = -30 u, k = u), so its lse is too: the mask is what keeps its dq
    finite."""
    b, n, s, d = case
    scale = d ** -0.5
    q, k, v, do = (torch.tensor(a) for a in _qkvg((b, n, s, d, None), 8))
    q[1] = -30.0
    k[1] = 1.0
    lse = tflash.flash_attention_fwd_plain(q, k, v, scale)[1]
    delta = tflash.bwd_delta(torch.randn(b, n, d, generator=torch.Generator().manual_seed(8)), do)
    assert lse[1].max() < -100  # exp(-lse) overflows float32
    want_dk, want_dv = tflash.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    want_dq = tflash.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    got_dk, got_dv = _dkv_model(q, k, v, do, lse, delta, scale)
    got_dq = _dq_model(q, k, v, do, lse, delta, scale)
    for name, got, want in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv),
                            ("dq", got_dq, want_dq)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    # without the mask the zero-filled keys are not inert
    assert torch.isnan(_dq_model(q, k, v, do, lse, delta, scale, mask=False)).any()


def test_fused_self_function_matches_jax_backward():
    b, n, heads, dh = 3, 10, 2, 16
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.normal(size=(b, n, heads * dh)).astype(np.float32) for _ in range(4))
    want = _fused_self_bwd(heads, None, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfused.FusedSelfMHAFunction.apply(tq, tk, tv, heads, None)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=ATOL)


def test_fused_cross_function_matches_jax_backward():
    b, n, s, heads, dh = 2, 12, 7, 2, 16
    rng = np.random.default_rng(5)
    q, g = (rng.normal(size=(b, n, heads * dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, heads * dh)).astype(np.float32) for _ in range(2))
    want = _fused_cross_bwd(heads, 0.3, tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfused.FusedCrossMHAFunction.apply(tq, tk, tv, heads, 0.3)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=ATOL)
    # only q asks for a gradient (frozen k/v projections): one gradient back
    out = tfused.FusedCrossMHAFunction.apply(tq, tk.detach(), tv.detach(), heads, 0.3)
    (dq,) = torch.autograd.grad(out, (tq,), torch.tensor(g))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want[0]), atol=ATOL)


def test_relpos_function_matches_jax_backward():
    bb, t, n, heads, dh = 2, 4, 6, 2, 8
    rng = np.random.default_rng(6)
    q, k, v, g = (rng.normal(size=(bb * t, n, heads * dh)).astype(np.float32) for _ in range(4))
    k2, v2 = (rng.normal(size=(t, t, dh)).astype(np.float32) for _ in range(2))
    scale = dh ** -0.5
    want = _relpos_bwd(heads, t, scale, True, tuple(map(jnp.asarray, (q, k, v, k2, v2))),
                               jnp.asarray(g))
    leaves = _t(q, k, v, k2, v2, grad=True)
    out = trelpos.RelposMHAFunction.apply(*leaves, heads, t, scale)
    got = torch.autograd.grad(out, leaves, torch.tensor(g))
    assert len(got) == 5
    for name, a, b_ in zip(("dq", "dk", "dv", "dK2", "dV2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=ATOL, err_msg=name)


def test_chain_function_matches_jax_grad_through_the_pallas_chain():
    c, f, hw, b = 32, 3, 4, 1
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, f, hw, c)).astype(np.float32)
    layers = [(1.0 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c),
               rng.normal(size=(3, c, c)) / np.sqrt(3 * c), 0.1 * rng.normal(size=c))
              for _ in range(4)]
    layers = [tuple(a.astype(np.float32) for a in layer) for layer in layers]

    def loss(xx, ll):
        return jnp.sum(j_temporal_conv_chain(xx, ll, interpret=True) ** 2)

    jl = tuple(tuple(map(jnp.asarray, layer)) for layer in layers)
    want_x, want_l = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jl)

    tx = torch.tensor(x, requires_grad=True)
    flat = [torch.tensor(a, requires_grad=True) for layer in layers for a in layer]
    out = ttc.TemporalConvChainFunction.apply(1e-5, tx, *flat)
    got = torch.autograd.grad((out ** 2).sum(), (tx, *flat))
    assert len(got) == 17
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_x), atol=1e-3, rtol=1e-3)
    for a, b_ in zip(got[1:], jax.tree.leaves(want_l)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-3, rtol=1e-3)
    # the CPU dispatch (plain layers under autograd) gives the same gradients
    tx2 = torch.tensor(x, requires_grad=True)
    grouped = [flat[i:i + 4] for i in range(0, 16, 4)]
    again = torch.autograd.grad((ttc.temporal_conv_chain(tx2, grouped) ** 2).sum(), (tx2, *flat))
    for a, b_ in zip(got, again):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5, rtol=1e-5)
