"""The port's VAE (decoder, encoder, posterior), CLIP text tower, tokenizer
and text encoder against the JAX package's at tiny configs in fp32, and the
VAE / CLIP converter round trips.

Tolerances: float decoder, encoder and text-tower outputs to 1e-4 absolute and
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
from t2v.models.vae import DiagonalGaussian as JGaussian
from t2v.models.vae import make_decode_uint8_fn, make_encode_latents_fn
from t2v.text.clip import CLIPTextTransformer as JClip
from t2v.text.clip import convert_open_clip_text
from t2v.text.encoder import TextEncoder as JTextEncoder
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import CLIPTextConfig, VAEConfig
from t2v_torch.io import convert
from t2v_torch.models.vae import AutoencoderKL, DiagonalGaussian, decode_uint8, encode_latents
from t2v_torch.pipeline.pipeline import DECODE_CHUNK, compute_latents
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.encoder import TextEncoder
from t2v_torch.text.tokenizer import CLIPTokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


def _port_vae(params):
    cfg = VAEConfig().tiny()
    return convert.load_into(AutoencoderKL(cfg), convert.from_jax_vae(params, cfg)).eval()


def test_vae_encode_matches_jax(vae_params):
    x = np.random.default_rng(3).uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    jvae = JVAE(cfg=JVAECfg().tiny())
    want_mean, want_logvar = jax.jit(lambda p, x: jvae.apply(p, x, method=JVAE.encode))(
        vae_params, x)
    vae = _port_vae(vae_params)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(x))
    assert mean.shape == logvar.shape == (3, 16, 16, 4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want_logvar), **TOL)

    want = np.asarray(make_encode_latents_fn(jvae, 0.18215)(vae_params, jnp.asarray(x)))
    got = encode_latents(vae, torch.from_numpy(x), 0.18215)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vae_encode_clips_the_logvar(vae_params):
    """A quant_conv bias of +-100 on the logvar channels drives them past
    both ends of [-30, 20] in both packages."""
    jvae = JVAE(cfg=JVAECfg().tiny())
    x = np.random.default_rng(4).uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.array, vae_params)
    params["params"]["quant_conv"]["bias"][4:] = np.array([100.0, -100.0, 100.0, -100.0])
    _, want = jvae.apply(params, x, method=JVAE.encode)
    with torch.no_grad():
        _, logvar = _port_vae(params).encode(torch.from_numpy(x))
    assert logvar.max() == 20.0 and logvar.min() == -30.0
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want), **TOL)


def test_compute_latents_chunks_frames(vae_params):
    frames = np.random.default_rng(5).uniform(-1, 1, size=(DECODE_CHUNK + 3, 32, 32, 3)).astype(
        np.float32)
    jvae = JVAE(cfg=JVAECfg().tiny())
    want = np.asarray(make_encode_latents_fn(jvae, 0.18215)(vae_params, jnp.asarray(frames)))[None]
    vae = _port_vae(vae_params)
    for given in (frames, torch.from_numpy(frames)):
        got = compute_latents(vae, given, 0.18215, torch.device("cpu"))
        assert got.shape == (1, DECODE_CHUNK + 3, 16, 16, 4) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("deterministic", [False, True])
def test_diagonal_gaussian_matches_jax(deterministic):
    rng = np.random.default_rng(6)
    f = lambda: rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    mean, logvar, noise, sample, mean2, logvar2 = (f() for _ in range(6))
    mine = DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar), deterministic)
    theirs = JGaussian(jnp.asarray(mean), jnp.asarray(logvar), deterministic)
    other = DiagonalGaussian(torch.from_numpy(mean2), torch.from_numpy(logvar2))
    jother = JGaussian(jnp.asarray(mean2), jnp.asarray(logvar2))
    pairs = [
        (mine.sample(noise=torch.from_numpy(noise)), theirs.sample(noise=jnp.asarray(noise))),
        (mine.kl(), theirs.kl()), (mine.kl(other), theirs.kl(jother)),
        (mine.nll(torch.from_numpy(sample)), theirs.nll(jnp.asarray(sample))),
        (mine.mode(), theirs.mode()), (mine.std, theirs.std), (mine.var, theirs.var),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    drawn = mine.sample(generator=torch.Generator().manual_seed(0))
    again = mine.sample(generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again) and (torch.equal(drawn, mine.mean) == deterministic)


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
