"""The loops of the rel-pos temporal attention kernel
(``t2v_torch/csrc/relpos_mha.cu``) modelled in torch on the CPU, under the
tile plans the card runs (``relpos_plan``), against ``relpos_mha_plain``
and, at float32, against the JAX package's ``relpos_ref``.

The model keeps the kernel's data layout and its three phases:

* a tile is (sample, run of ``nt`` tokens, ``hb`` heads): rows (frame,
  pair) with the head dim padded to the kernel's DP by zeros (the zero
  chunk), frames past T zero, and the rows of tokens past N holding
  whatever the buffer held before (NaN here, to show that no other row
  reads them);
* token-major, per query frame and 16-row group of pairs: the score bias
  q_p[tq] . K2[tq]^T, stored to each pair's f32 slot;
* frame-major, per pair: q . k^T plus the bias from the slot, keys past T
  masked, the softmax, P rounded to v's dtype, and O1 = P . v kept in f32;
* token-major again: P_p[tq] . V2[tq] added to O1 in f32 and rounded once.

Tolerances: rtol = atol = 2e-5 at float32 (the same float32 arithmetic in
another summation order); at bf16 inputs, against the plain version, one
bf16 step of the largest |output| (both round P and the output to bf16
from float32 sums taken in another order, which can flip one rounding).
The model must fail when the bias exchange or the V2 term is dropped.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from t2v.kernels.relpos_mha import relpos_ref
from t2v_torch.kernels import relpos_mha as trelpos
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_STEP = 2.0 ** -7


def _cut(case):
    """A chip_smoke.py case with N cut small, and the (tokens, heads) of a
    tile that the card's plan takes at the full shape: the last run of
    tokens is short wherever a tile holds more than one."""
    b, t, n, h, d = case
    plan = trelpos.relpos_plan(b, t, n, h, d)
    nt = plan.tokens_per_block
    return (b, t, min(n, 2 * nt + 1), h, d), nt, plan.heads_per_block


def _tile_model(q, k, v, k2, v2, heads, t, scale, nt, hb, bias=True, v2_term=True):
    """The kernel's tile loops (see the module docstring) in float32 with
    its rounding points: P to v's dtype, the output once to q's dtype."""
    bt, n, hd = q.shape
    b = bt // t
    d = hd // heads
    dp = next(p for p in trelpos.PADDED_D if d <= p)
    tp = 16 * -(-t // 16)
    pairs = nt * hb
    groups = -(-pairs // 16)
    split = lambda x: x.float().reshape(b, t, n, heads, d)  # noqa: E731
    qs, ks, vs = split(q), split(k), split(v)
    # the tables as B operands: keys padded to tp, columns to dp, by zeros
    k2p, v2p = (torch.zeros(t, tp, dp) for _ in range(2))
    k2p[:, :t, :d] = k2.to(q.dtype).float()
    v2p[:, :t, :d] = v2.to(q.dtype).float()
    out = torch.full((b, t, n, heads, d), float("nan"))
    for bi in range(b):
        for n0 in range(0, n, nt):
            for h0 in range(0, heads, hb):
                valid = min(nt, n - n0)

                def region(x):
                    r = torch.zeros(tp, pairs, dp)
                    r[:t, :, :d] = float("nan")  # stale rows of tokens past N
                    r[:t, :valid * hb, :d] = x[bi, :, n0:n0 + valid, h0:h0 + hb].reshape(
                        t, valid * hb, d)
                    return r

                qr, kr, vr = region(qs), region(ks), region(vs)
                slot = torch.zeros(pairs, tp, tp)  # f32 bias, then P
                # 1. token-major bias over 16-row groups; rows past P read zeros
                for tq in range(t):
                    for g0 in range(0, groups * 16, 16):
                        a = torch.zeros(16, dp)
                        rows = min(16, pairs - g0)
                        a[:rows] = qr[tq, g0:g0 + rows]
                        slot[g0:g0 + rows, tq] = (a @ k2p[tq].T)[:rows]
                # 2. frame-major per pair: scores, softmax, P, O1
                o1 = torch.zeros(pairs, tp, dp)
                for p in range(pairs):
                    s = qr[:, p] @ kr[:, p].T
                    if bias:
                        s[:t] = s[:t] + slot[p, :t]
                    s[:, t:] = float("-inf")
                    prob = torch.softmax(s * scale, dim=-1).to(v.dtype).float()
                    slot[p] = prob
                    o1[p] = prob @ vr[:, p]
                # 3. token-major P . V2 added to O1, rounded once
                for tq in range(t):
                    for g0 in range(0, groups * 16, 16):
                        a = torch.zeros(16, tp)
                        rows = min(16, pairs - g0)
                        a[:rows] = slot[g0:g0 + rows, tq]
                        o2 = (a @ v2p[tq])[:rows]
                        res = o1[g0:g0 + rows, tq] + (o2 if v2_term else 0.0)
                        for r in range(rows):
                            j, h = divmod(g0 + r, hb)
                            if j < valid:
                                out[bi, tq, n0 + j, h0 + h] = res[r, :d].to(q.dtype).float()
    return out.reshape(bt, n, hd)


def _inputs(case, seed, dtype=torch.float32):
    b, t, n, h, d = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b * t, n, h * d)).astype(np.float32) for _ in range(3))
    k2, v2 = (0.5 * rng.normal(size=(t, t, d)).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v, k2, v2)]


def test_tile_model_matches_plain_and_jax_reference():
    """At every chip_smoke.py case with N cut small (T = 5, 16, 24, 40 and
    64; D = 16, 24, 40, 80 and 160; tiles of 1 to 16 pairs, 15-pair tiles
    and short last runs), under the card's tile plan, in float32."""
    for i, full in enumerate(chip_smoke.RELPOS_CASES):
        (b, t, n, h, d), nt, hb = _cut(full)
        scale = d ** -0.5
        q, k, v, k2, v2 = _inputs((b, t, n, h, d), i)
        got = _tile_model(q, k, v, k2, v2, h, t, scale, nt, hb)
        plain = trelpos.relpos_mha_plain(q, k, v, k2, v2, h, t, scale)
        ref = np.asarray(relpos_ref(*map(jnp.asarray, (q, k, v, k2, v2)), h, t, scale))
        assert torch.isfinite(got).all(), full
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL, err_msg=str(full))
        np.testing.assert_allclose(got.numpy(), ref, **TOL, err_msg=str(full))


def test_tile_model_rounds_where_the_plain_version_does():
    """bf16 inputs: P rounded to bf16 before both output products and the
    f32 sum of the two terms rounded once, as relpos_mha_plain does."""
    for i, full in enumerate(chip_smoke.RELPOS_PATH):
        (b, t, n, h, d), nt, hb = _cut(full)
        q, k, v, k2, v2 = _inputs((b, t, n, h, d), 10 + i, torch.bfloat16)
        got = _tile_model(q, k, v, k2, v2, h, t, d ** -0.5, nt, hb)
        want = trelpos.relpos_mha_plain(q, k, v, k2, v2, h, t).float()
        assert (got - want).abs().max() <= BF16_STEP * want.abs().max(), full


def test_tile_model_needs_the_bias_exchange_and_the_v2_term():
    """Dropping the token-major bias from the scores, or the V2 product
    from the output, takes the model far outside the tolerance."""
    (b, t, n, h, d), nt, hb = _cut(chip_smoke.RELPOS_PATH[0])
    q, k, v, k2, v2 = _inputs((b, t, n, h, d), 20)
    want = trelpos.relpos_mha_plain(q, k, v, k2, v2, h, t).numpy()
    for kwargs in (dict(bias=False), dict(v2_term=False)):
        got = _tile_model(q, k, v, k2, v2, h, t, d ** -0.5, nt, hb, **kwargs).numpy()
        err = np.abs(got - want).max()
        assert err > 100 * (TOL["atol"] + TOL["rtol"] * np.abs(want).max()), (kwargs, err)
