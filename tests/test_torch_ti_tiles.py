"""Textual inversion and the VAE's tiles and attention, the port against
the JAX package at tiny configs in fp32: chunking with embeddings, the
``EmbeddingDB`` file layouts, the embedding splice through the ViT-H
(open_clip) and the CLIP-L (Hugging Face) towers, the line cache's
invalidation on registration, VAE attention at down and up resolutions,
and the tiled decode and encode, alone and through
``ModelScopePipeline.decode_latents``.

Tolerances: token ids, multipliers, splice positions and embedding rows
exactly; tower, VAE and tiled outputs to rtol = atol = 2e-4 (float32 on
both sides, another summation order); uint8 frames within one level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import VAEConfig as JVAECfg
from t2v.core.dtypes import Policy as JPolicy
from t2v.models.vae import AutoencoderKL as JVAE
from t2v.models.vae_tiled import decode_spatial_tiled as j_decode_tiled
from t2v.models.vae_tiled import encode_spatial_tiled as j_encode_tiled
from t2v.pipeline.pipeline import ModelScopePipeline as JPipeline
from t2v.text import chunking as jchunking
from t2v.text.clip import CLIPTextTransformer as JClip
from t2v.text.encoder import EmbeddingDB as JEmbeddingDB
from t2v.text.encoder import TextEncoder as JTextEncoder
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import CLIPTextConfig, VAEConfig
from t2v_torch.core.dtypes import Policy
from t2v_torch.io import convert
from t2v_torch.io.safetensors_io import save_safetensors
from t2v_torch.models.vae import AutoencoderKL
from t2v_torch.models.vae_tiled import decode_spatial_tiled, encode_spatial_tiled
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from t2v_torch.text import chunking
from t2v_torch.text.clip import CLIPTextTransformer, HFCLIPTextModel
from t2v_torch.text.encoder import EmbeddingDB, TextEncoder
from t2v_torch.text.tokenizer import CLIPTokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
WIDTH = 32
RNG = np.random.default_rng(7)
# name -> rows: one-token and multi-token names, a name that prefixes a
# longer one, and a 60-row embedding that does not fit beside long text
EMBEDS = {"bunny": RNG.normal(size=(2, WIDTH)).astype(np.float32),
          "cat dog": RNG.normal(size=(3, WIDTH)).astype(np.float32),
          "cat": RNG.normal(size=(1, WIDTH)).astype(np.float32),
          "forest": RNG.normal(size=(60, WIDTH)).astype(np.float32)}
PROMPTS = ["a bunny in the forest", "a (cat dog:1.3) and a [cat], bunny",
           "the cat, " * 20 + "bunny BREAK a cat dog", "photo of " * 30 + "forest, bunny",
           "a photo"]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32), params)


def _dbs():
    mine, theirs = EmbeddingDB(CLIPTokenizer.for_tests()), JEmbeddingDB(JTokenizer.for_tests())
    for name, vec in EMBEDS.items():
        mine.register(name, vec)
        theirs.register(name, vec)
    return mine, theirs


def test_chunking_with_embeddings_matches_jax():
    mine_db, their_db = _dbs()
    for prompt in PROMPTS:
        for backtrack in (0, 20):
            got, n = chunking.tokenize_line(prompt, CLIPTokenizer.for_tests(),
                                            comma_backtrack=backtrack, embedding_db=mine_db.find)
            want, m = jchunking.tokenize_line(prompt, JTokenizer.for_tests(),
                                              comma_backtrack=backtrack,
                                              embedding_db=their_db.find)
            assert n == m and len(got) == len(want)
            for a, b in zip(got, want):
                assert a.tokens == b.tokens and a.multipliers == b.multipliers
                assert [p for p, _ in a.fixes] == [p for p, _ in b.fixes]
                for (_, u), (_, v) in zip(a.fixes, b.fixes):
                    np.testing.assert_array_equal(u, v)
    assert any(ch.fixes for ch in chunking.tokenize_line(PROMPTS[0], CLIPTokenizer.for_tests(),
                                                         embedding_db=mine_db.find)[0])


def test_embedding_files_register_as_in_jax(tmp_path):
    """The A1111 layouts (``string_to_param`` .pt, ``emb_params`` .bin, a
    single tensor .pt, a .safetensors) register under their file names with
    the same rows in both packages; a file of another layout is skipped."""
    rows = {n: RNG.normal(size=(k, WIDTH)).astype(np.float32) for n, k in
            (("bunny", 2), ("cat", 1), ("dog", 3), ("forest", 1))}
    torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": torch.from_numpy(
        rows["bunny"])}, "name": "bunny", "step": 3000}, tmp_path / "bunny.pt")
    torch.save({"emb_params": torch.from_numpy(rows["cat"][0])}, tmp_path / "cat.bin")
    torch.save({"only": torch.from_numpy(rows["dog"])}, tmp_path / "dog.pt")
    save_safetensors(str(tmp_path / "forest.safetensors"), {"emb_params": rows["forest"]})
    torch.save({"a": torch.ones(2), "b": torch.ones(2)}, tmp_path / "two.pt")
    (tmp_path / "notes.txt").write_text("not an embedding")
    mine, theirs = EmbeddingDB(CLIPTokenizer.for_tests()), JEmbeddingDB(JTokenizer.for_tests())
    assert mine.load_dir(str(tmp_path)) == theirs.load_dir(str(tmp_path)) == [
        "bunny", "cat", "dog", "forest"]
    assert mine.version == theirs.version == 4 and mine.load_dir(str(tmp_path / "none")) == []
    tok = CLIPTokenizer.for_tests()
    for name, want in rows.items():
        ids = tok.encode(name)
        (got, n), (ref, m) = mine.find(ids, 0), theirs.find(ids, 0)
        assert n == m == len(ids)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="unrecognised embedding file layout"):
        mine.register_file(str(tmp_path / "two.pt"))


def _splice_setup():
    tok = JTokenizer.for_tests()
    jcfg = dataclasses.replace(JClipCfg().tiny(), width=WIDTH, vocab_size=tok.vocab_size)
    cfg = CLIPTextConfig(**dataclasses.asdict(jcfg))
    params = _perturbed(jax.jit(JClip(cfg=jcfg).init)(jax.random.key(2),
                                                      jnp.zeros((1, 77), jnp.int32)), 3)
    return jcfg, cfg, params


def test_splice_through_both_towers_matches_jax():
    """A prompt naming embeddings encodes as in the JAX package through the
    open_clip tower (``encode_line``: the +1 BOS offset, the 60-row
    embedding moved to the next chunk), and the CLIP-L tower takes the
    same spliced ``input_embeddings``; the line cache sees a later
    registration."""
    jcfg, cfg, params = _splice_setup()
    jenc = JTextEncoder(JClip(cfg=jcfg), params, JTokenizer.for_tests())
    tower = convert.load_into(CLIPTextTransformer(cfg), convert.from_jax_clip(params, cfg)).eval()
    enc = TextEncoder(tower, CLIPTokenizer.for_tests())
    plain = enc.encode_line(PROMPTS[1])
    np.testing.assert_allclose(plain.numpy(), jenc.encode_line(PROMPTS[1]), **TOL)
    for name, vec in EMBEDS.items():
        enc.embedding_db.register(name, vec)
        jenc.embedding_db.register(name, vec)
    spliced = enc.encode_line(PROMPTS[1])
    assert not torch.allclose(spliced, plain)
    for prompt in PROMPTS:
        np.testing.assert_allclose(enc.encode_line(prompt).numpy(), jenc.encode_line(prompt),
                                   **TOL)
    # the 60 rows do not fit beside 60 prompt tokens: they open the next chunk
    chunks, _ = chunking.tokenize_line(PROMPTS[3], CLIPTokenizer.for_tests(),
                                       embedding_db=enc.embedding_db.find)
    assert [(pos, len(v)) for ch in chunks for pos, v in ch.fixes][:1] == [(0, 60)]

    hf_cfg = dataclasses.replace(JClipCfg.clip_l_14(), width=WIDTH, layers=2, heads=2,
                                 vocab_size=jcfg.vocab_size)
    hf_params = _perturbed(jax.jit(JClip(cfg=hf_cfg).init)(jax.random.key(4),
                                                         jnp.zeros((1, 77), jnp.int32)), 5)
    hf_tcfg = CLIPTextConfig(**dataclasses.asdict(hf_cfg))
    hf = convert.load_into(HFCLIPTextModel(hf_tcfg),
                           convert.from_jax_clip(hf_params, hf_tcfg, layout="hf")).eval()
    chunk = chunking.tokenize_line(PROMPTS[0], CLIPTokenizer.for_tests(),
                                   embedding_db=enc.embedding_db.find)[0][0]
    ids = torch.tensor([chunk.tokens])
    with torch.no_grad():
        x = hf.token_embedding_weight[ids].clone()
        for pos, vec in chunk.fixes:
            x[0, pos + 1 : pos + 1 + len(vec)] = torch.from_numpy(vec)
        got = hf(ids, input_embeddings=x).numpy()
        assert not np.allclose(got, hf(ids).numpy())
    want = JClip(cfg=hf_cfg).apply(hf_params, jnp.asarray(ids.numpy(), jnp.int32),
                                   input_embeddings=jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _vae_pair(jcfg):
    params = _perturbed(jax.jit(JVAE(cfg=jcfg).init)(jax.random.key(1),
                                                     jnp.zeros((1, 32, 32, 3))), 0)
    cfg = VAEConfig(**dataclasses.asdict(jcfg))
    vae = convert.load_into(AutoencoderKL(cfg), convert.from_jax_vae(params, cfg)).eval()
    return params, cfg, vae


def test_vae_attention_at_down_and_up_resolutions_matches_jax():
    """Attention after every ResnetBlock of the 32- and 16-pixel levels
    (128- and 256-wide heads in the SD layout; the plain path here)."""
    jcfg = dataclasses.replace(JVAECfg().tiny(), resolution=32, attn_resolutions=(32, 16))
    params, cfg, vae = _vae_pair(jcfg)
    sd = vae.state_dict()
    assert {"encoder.down.0.attn.0.q.weight", "encoder.down.1.attn.0.q.weight",
            "decoder.up.1.attn.1.q.weight", "decoder.up.0.attn.1.q.weight"} <= set(sd)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    z = np.random.default_rng(2).normal(size=(2, 16, 16, 4)).astype(np.float32)
    jvae = JVAE(cfg=jcfg)
    want_mean, _ = jax.jit(lambda p, x: jvae.apply(p, x, method=JVAE.encode))(params, x)
    want_img = jax.jit(lambda p, z: jvae.apply(p, z, method=JVAE.decode))(params, z)
    with torch.no_grad():
        mean, _ = vae.encode(torch.from_numpy(x))
        img = vae.decode(torch.from_numpy(z))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)


def test_tiled_decode_and_encode_match_jax():
    """The tiles, ramps and blend on a latent taller and wider than the
    tile (ragged last tiles), and on images; the pipeline's ``decode_tile``
    route gives the JAX pipeline's frames, and a latent within the tile
    decodes untiled."""
    jcfg = JVAECfg().tiny()
    params, cfg, vae = _vae_pair(jcfg)
    jvae = JVAE(cfg=jcfg)
    j_dec = jax.jit(lambda z: jvae.apply(params, z, method=JVAE.decode))
    j_enc = jax.jit(lambda x: jvae.apply(params, x, method=JVAE.encode)[0])
    z = np.random.default_rng(3).normal(size=(2, 20, 27, 4)).astype(np.float32)
    x = np.random.default_rng(4).uniform(-1, 1, size=(2, 40, 54, 3)).astype(np.float32)
    with torch.no_grad():
        got = decode_spatial_tiled(vae.decode, torch.from_numpy(z), tile=12, overlap=4, upscale=2)
        got_lat = encode_spatial_tiled(lambda t: vae.encode(t)[0], torch.from_numpy(x), tile=24,
                                       overlap=8, downscale=2)
    np.testing.assert_allclose(got.numpy(), j_decode_tiled(j_dec, jnp.asarray(z), tile=12,
                                                           overlap=4, upscale=2), **TOL)
    np.testing.assert_allclose(got_lat.numpy(), j_encode_tiled(j_enc, jnp.asarray(x), tile=24,
                                                               overlap=8, downscale=2), **TOL)

    jpipe = JPipeline(unet_cfg=None, vae_cfg=jcfg, clip_cfg=None, policy=JPolicy.fp32(),
                      unet=None, vae=jvae, unet_params=None, vae_params=params,
                      text_encoder=None, schedule=None, decode_tile=12, decode_tile_overlap=4)
    pipe = ModelScopePipeline(unet_cfg=None, vae_cfg=cfg, clip_cfg=None, policy=Policy.fp32(),
                              unet=None, vae=vae, text_encoder=None, schedule=None,
                              device=torch.device("cpu"), decode_tile=12, decode_tile_overlap=4)
    lat = 0.18215 * z
    for shape in ((2, 20, 27), (2, 12, 12)):
        sub = lat[:, : shape[1], : shape[2]]
        want = jpipe.decode_latents(jnp.asarray(sub))
        got = pipe.decode_latents(torch.from_numpy(sub))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
