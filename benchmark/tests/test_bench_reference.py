"""The plain reference against the port at tiny sizes on the CPU, both in
float32 on the same seeded weights: the UNets, the VAE, the text towers and
their tokenisation, the samplers' plans and steps."""

import numpy as np
import pytest
import torch

from benchmark import program, prompts, weights
from benchmark.reference import modelscope, sampling, text, vae, videocrafter
from benchmark.tests.conftest import tiny_config

TOL = 1e-4  # float32 against float32: the sums run in another order


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _pipe(config_name):
    cfg = tiny_config(config_name)
    return cfg, program.build(cfg, 123, torch.device("cpu")), \
        program.reference_weights(cfg, 123, torch.device("cpu"), torch.float32)


@pytest.mark.parametrize("config_name,frames", [("modelscope_t2v_1.7b", 5), ("videocrafter_t2v_base", 4)])
def test_unet(config_name, frames):
    cfg, pipe, sd = _pipe(config_name)
    mod = modelscope if cfg["family"] == "modelscope" else videocrafter
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, frames, 8, 8, 4, generator=g)
    t = torch.tensor([981.0, 21.0])
    ctx = torch.randn(2, 77, 64, generator=g)
    with torch.no_grad():
        got = pipe.unet(x, t, ctx)
    want = mod.forward(sd["unet"], cfg["unet"], x, t, ctx)
    assert _rel(got, want) < TOL


def test_vae():
    cfg, pipe, sd = _pipe("modelscope_t2v_1.7b")
    g = torch.Generator().manual_seed(1)
    z = torch.randn(3, 8, 8, 4, generator=g)
    with torch.no_grad():
        got = pipe.vae.decode(z)
        mean, _ = pipe.vae.encode(got.clamp(-1, 1))
    assert _rel(got, vae.decode(sd["vae"], cfg["vae"], z)) < TOL
    assert _rel(mean, vae.encode_mean(sd["vae"], cfg["vae"], got.clamp(-1, 1))) < TOL
    frames = pipe.decode_latents(z)
    want = vae.decode_frames(sd["vae"], cfg["vae"], z, cfg["vae"]["scale_factor"]).numpy()
    assert np.abs(frames.astype(int) - want.astype(int)).max() <= 1


def _prompts(cfg, n=40):
    from benchmark import spec

    params = spec.load_json(f"{spec.HERE}/traffic/webui_24f_ddim_gaussian_30.json")["prompt"]
    tok = text.Tokenizer(cfg["tokenizer"]["merge_words"])
    return tok, [prompts.request(params, tok, 99, i)[0] for i in range(n)]


def test_tokenizer_and_chunk():
    from t2v_torch.text import chunking
    from t2v_torch.text.tokenizer import CLIPTokenizer

    cfg = tiny_config("modelscope_t2v_1.7b")
    tok, ps = _prompts(cfg)
    port = CLIPTokenizer.for_tests()
    assert any("(" in p for p in ps)
    for p in ps + ["text, watermark, copyright, blurry, nsfw", "(Forest:1.3) at 4.5 o'clock!"]:
        assert tok.encode(p) == port.encode(p), p
        chunks, _ = chunking.tokenize_line(p, port)
        assert len(chunks) == 1
        ids = chunking.pad_after_eos(np.asarray([chunks[0].tokens]), port.eos_id, 0)[0]
        want_ids, want_mult = text.modelscope_chunk(tok, p)
        assert list(ids) == want_ids and chunks[0].multipliers == want_mult, p


@pytest.mark.parametrize("config_name", ["modelscope_t2v_1.7b", "videocrafter_t2v_base"])
def test_text_context(config_name):
    cfg, pipe, sd = _pipe(config_name)
    tok, ps = _prompts(cfg, 6)
    for p in ps + ["text, watermark, copyright, blurry, nsfw"]:
        if cfg["family"] == "modelscope":
            got = pipe.text_encoder.encode_line(p)[None]
            want = text.modelscope_context(sd["text"], cfg["text"], tok, p)
        else:
            got = pipe.encode_text([p])
            want = text.videocrafter_context(sd["text"], cfg["text"], tok, p)
        assert _rel(got, want) < TOL, p


@pytest.mark.parametrize("sampler,module", [("DDIM_Gaussian", "ddim_gaussian"), ("DDIM", "ddim")])
def test_sampler(sampler, module):
    import importlib

    from t2v_torch.diffusion.schedules import DiffusionSchedule

    mod = importlib.import_module(f"t2v_torch.diffusion.{module}")
    p = mod.plan(DiffusionSchedule.linear_sd(1000), 30, 0.0)
    ref = sampling.plan(sampler, 30)
    assert [r[0] for r in ref] == [int(t) for t in p.timesteps]
    g = torch.Generator().manual_seed(2)
    x, eps = torch.randn(1, 3, 4, 4, 4, generator=g), torch.randn(1, 3, 4, 4, 4, generator=g)
    for i in (0, 13, len(ref) - 1):
        assert _rel(mod.step(x, eps, p, i, None), sampling.step(sampler, x, eps, ref[i])) < 1e-6


def test_guidance():
    from t2v_torch.diffusion.sampling import cfg_combine

    g = torch.Generator().manual_seed(3)
    out = torch.randn(2, 3, 4, 4, 4, generator=g)
    u, y = out.chunk(2)
    assert torch.equal(sampling.guide("DDIM_Gaussian", out, 17.0),
                       cfg_combine(y, u, 17.0, "split_learned_range"))
    assert torch.allclose(sampling.guide("DDIM", out, 17.0), cfg_combine(y, u, 17.0, "full"))


def test_weights_are_the_programs():
    """The reference's weights are the values the port holds, and every
    zero-initialised gate of the published models is drawn non-zero."""
    cfg, pipe, sd = _pipe("videocrafter_t2v_base")
    for name, p in pipe.unet.named_parameters():
        assert torch.equal(p, sd["unet"][name]), name
        assert p.abs().max() > 0, name
    shapes = program.param_shapes(cfg)["unet"]
    again = dict(weights.draw(shapes, 123, "cpu", torch.float32))
    assert all(torch.equal(again[k], sd["unet"][k]) for k in again)
