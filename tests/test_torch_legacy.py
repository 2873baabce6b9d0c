"""The port's legacy 2-D blocks (``t2v_torch/models/legacy.py``) against the
JAX package's (``t2v/models/legacy.py``) at fp32 on the CPU, with the flax
weights carried across by ``io/convert.py::from_jax_legacy``.

Each block's zero-initialised closing layer is given signal first, so that
a carry-over fault there shows. Tolerance: 2e-5 absolute on O(1) outputs
(float32 GroupNorm, convolutions and attention summed in another order), as
the JAX package's own tests hold these blocks to their torch oracle;
``resample``'s gathers exactly, its mean of four to 1e-7 (one float32
rounding: the four are summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.dtypes import Policy as JPolicy
from t2v.models import legacy as JL
from t2v_torch.io.convert import from_jax_legacy
from t2v_torch.models import legacy as L
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

P32 = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TOL = 2e-5


def _rnd(rng, *shape, scale=0.5):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _carried(module: torch.nn.Module, params) -> torch.nn.Module:
    sd = {k: torch.from_numpy(np.array(v)) for k, v in from_jax_legacy(params).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _signal(params, name: str, rng):
    """``params`` with the zero-initialised leaves of ``name`` replaced."""
    p = jax.tree.map(np.asarray, params["params"])
    p[name] = {k: _rnd(rng, *np.shape(v), scale=0.1) for k, v in p[name].items()}
    return {"params": p}


def test_resample_matches_jax_in_every_mode():
    rng = np.random.default_rng(0)
    for shape, ref in (((2, 8, 6, 3), (16, 12)), ((1, 4, 5, 2), (8, 10)), ((2, 6, 6, 4), (9, 7))):
        x = _rnd(rng, *shape)
        for mode in ("none", "upsample", "downsample"):
            ref_hw = ref if mode == "upsample" else None
            if mode == "downsample" and (shape[1] % 2 or shape[2] % 2):
                for resample, arr in ((JL.resample, jnp.asarray(x)),
                                      (L.resample, torch.from_numpy(x))):
                    with pytest.raises(ValueError, match="even"):
                        resample(arr, mode)
                continue
            want = np.asarray(JL.resample(jnp.asarray(x), mode, ref_hw))
            got = L.resample(torch.from_numpy(x), mode, ref_hw).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 if mode == "downsample" else 0,
                                       err_msg=f"{mode} {shape}")
    with pytest.raises(ValueError, match="reference"):
        L.resample(torch.zeros(1, 2, 2, 1), "upsample")
    with pytest.raises(ValueError, match="unknown"):
        L.resample(torch.zeros(1, 2, 2, 1), "sideways")


@pytest.mark.parametrize("mode", ["none", "upsample", "downsample"])
def test_residual_block_matches_jax(mode):
    """Every resample mode, with the scale-shift embedding and the additive
    one, the width kept and changed (the 1x1 shortcut)."""
    rng = np.random.default_rng(1)
    for use_ssn, in_dim, out_dim in ((True, 64, 96), (False, 64, 64), (False, 32, 64)):
        kw = dict(in_dim=in_dim, embed_dim=24, out_dim=out_dim, use_scale_shift_norm=use_ssn,
                  mode=mode)
        x, e = _rnd(rng, 2, 8, 8, in_dim), _rnd(rng, 2, 24)
        ref_hw = (16, 16) if mode == "upsample" else None
        jblock = JL.LegacyResidualBlock(**kw, policy=P32)
        params = jblock.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(e), ref_hw)
        params = _signal(params, "conv2", rng)
        want = np.asarray(jblock.apply(params, jnp.asarray(x), jnp.asarray(e), ref_hw))
        block = _carried(L.LegacyResidualBlock(**kw), params)
        assert (block.shortcut is None) == (in_dim == out_dim)
        with torch.no_grad():
            got = block(torch.from_numpy(x), torch.from_numpy(e), ref_hw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=f"{mode} {use_ssn} {in_dim}")


def test_attention_block_matches_jax_with_and_without_context():
    """Self-attention and context rows prepended, heads from ``num_heads``
    and from ``head_dim``; the last case is UNetSD's first level cut to a
    16x16 map: 320 channels in 5 heads of 64, 77 context rows (333 keys)."""
    rng = np.random.default_rng(2)
    cases = [((2, 6, 6, 64), dict(num_heads=4), None),
             ((2, 6, 6, 64), dict(num_heads=4), 24),
             ((1, 4, 5, 64), dict(head_dim=16, num_heads=2), 12),
             ((1, 16, 16, 320), dict(num_heads=5), 77)]
    for shape, heads, ctx_len in cases:
        dim = shape[-1]
        ctx_dim = 32 if ctx_len else None
        x = _rnd(rng, *shape)
        ctx = _rnd(rng, shape[0], ctx_len, 32) if ctx_len else None
        args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if ctx_len else ())
        jblock = JL.LegacyAttentionBlock(dim=dim, context_dim=ctx_dim, **heads, policy=P32)
        params = _signal(jblock.init(jax.random.key(0), *args), "proj", rng)
        want = np.asarray(jblock.apply(params, *args))
        block = _carried(L.LegacyAttentionBlock(dim, ctx_dim, **heads), params)
        with torch.no_grad():
            got = block(torch.from_numpy(x),
                        None if ctx is None else torch.from_numpy(ctx)).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=f"{shape} {heads} {ctx_len}")
    with pytest.raises(ValueError, match="num_heads"):
        L.LegacyAttentionBlock(64, num_heads=3)
