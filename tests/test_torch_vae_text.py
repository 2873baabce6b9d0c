"""The port's VAE decoder, CLIP text tower, tokenizer and text encoder
against the JAX package's at tiny configs in fp32, and the VAE / CLIP
converter round trips.

Tolerances: float decoder and text-tower outputs to 1e-4 absolute and
relative (float32 on both sides, another summation order); uint8 frames
within one level (a value on a rounding edge may round either way);
tokenizer ids exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import VAEConfig as JVAECfg
from t2v.io.convert import convert_vae
from t2v.models.vae import AutoencoderKL as JVAE
from t2v.models.vae import make_decode_uint8_fn
from t2v.text.clip import CLIPTextTransformer as JClip
from t2v.text.clip import convert_open_clip_text
from t2v.text.encoder import TextEncoder as JTextEncoder
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import CLIPTextConfig, VAEConfig
from t2v_torch.io import convert
from t2v_torch.models.vae import AutoencoderKL, decode_uint8
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.encoder import TextEncoder
from t2v_torch.text.tokenizer import CLIPTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def vae_params():
    params = jax.jit(JVAE(cfg=JVAECfg().tiny()).init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    return _perturbed(params, 0)


def test_vae_decode_matches_jax(vae_params):
    z = np.random.default_rng(2).normal(size=(3, 8, 8, 4)).astype(np.float32)
    jvae = JVAE(cfg=JVAECfg().tiny())
    want = np.asarray(jax.jit(lambda p, z: jvae.apply(p, z, method=JVAE.decode))(vae_params, z))
    cfg = VAEConfig().tiny()
    vae = convert.load_into(AutoencoderKL(cfg), convert.from_jax_vae(vae_params, cfg)).eval()
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)

    want_u8 = np.asarray(make_decode_uint8_fn(jvae, 0.18215)(vae_params, jnp.asarray(z)))
    got_u8 = decode_uint8(vae, torch.from_numpy(z), 0.18215).numpy()
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


def test_from_jax_vae_round_trips_through_convert_vae(vae_params):
    back = convert_vae(convert.from_jax_vae(vae_params, VAEConfig().tiny()), JVAECfg().tiny())
    a, b = _flat(vae_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])


def _clip_cfgs():
    tok = JTokenizer.for_tests()
    jcfg = dataclasses.replace(JClipCfg().tiny(), width=32, vocab_size=tok.vocab_size)
    cfg = dataclasses.replace(CLIPTextConfig().tiny(), width=32, vocab_size=tok.vocab_size)
    return jcfg, cfg


@pytest.fixture(scope="module")
def clip_params():
    jcfg, _ = _clip_cfgs()
    params = jax.jit(JClip(cfg=jcfg).init)(jax.random.key(2), jnp.zeros((1, 77), jnp.int32))
    return _perturbed(params, 3)


def _port_clip(clip_params):
    _, cfg = _clip_cfgs()
    return convert.load_into(CLIPTextTransformer(cfg), convert.from_jax_clip(clip_params, cfg)).eval()


def test_clip_tower_matches_jax(clip_params):
    jcfg, _ = _clip_cfgs()
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=(2, 77)).astype(np.int32)
    want = np.asarray(jax.jit(JClip(cfg=jcfg).apply)(clip_params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port_clip(clip_params)(torch.from_numpy(tokens.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_from_jax_clip_round_trips(clip_params):
    jcfg, cfg = _clip_cfgs()
    back = convert_open_clip_text(convert.from_jax_clip(clip_params, cfg), jcfg)
    a, b = _flat(clip_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("text", [
    "a photo of the cat in a forest", "It's a DOG's life, isn't it?!", "cafÃ© 3.14 2x4",
    "  emoji 🐱🐶 and   spaces\tand\nlines ", "日本語のテキスト, ½ ² Ⅻ", "<|startoftext|>x<|endoftext|>",
    "!'s (masterpiece:1.2) [[blurry]] \\(lit\\)", "a&amp;b &lt;tag&gt; ' 'll",
])
def test_tokenizer_matches_jax(text):
    assert CLIPTokenizer.for_tests().encode(text) == JTokenizer.for_tests().encode(text)


@pytest.mark.parametrize("prompt,n_prompt,steps", [
    ("a (cat:1.4) in the [forest], masterpiece", "text, watermark, blurry", 4),
    ("a [dog:cat:2] in a [forest|field]", "", 4),
    ("the cat, " * 30 + "BREAK a dog", "blurry", 3),
])
def test_encode_request_matches_jax(clip_params, prompt, n_prompt, steps):
    jcfg, _ = _clip_cfgs()
    jenc = JTextEncoder(JClip(cfg=jcfg), clip_params, JTokenizer.for_tests())
    want = jenc.encode_request(prompt, n_prompt, steps)
    enc = TextEncoder(_port_clip(clip_params), CLIPTokenizer.for_tests())
    got = enc.encode_request(prompt, n_prompt, steps)
    for g, w in ((got.cond, want.cond), (got.uncond, want.uncond)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
