"""The port's checkpoint loading against the JAX package's, on tiny model
directories written in the published ModelScope layout
(``tests/_torch_model_dir.py``): the vocab-file tokenizer, the
``configuration.json`` parser, ``from_model_dir`` (float32 and float16
UNet files), the trainer's own layout (``from_native``), stable-lora
merges into the UNet and the text tower, ``load_pipeline``'s cache and hot
switch, and the 'Main Model Only' release and reload.

Tolerances: token ids, configs and loaded weights exactly (the same stored
values, cast once to float32 by either package); LoRA merges within 1e-6
relative (float32 products summed in another order); frames after a
release and reload exactly (the same weights on the same device).
"""

import dataclasses
import gzip
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.core.config import T2VOutputArgs as JOutputArgs
from t2v.core.config import VAEConfig as JVAECfg
from t2v.core.dtypes import Policy as JPolicy
from t2v.pipeline import pipeline as jpipeline
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core import config as tconfig
from t2v_torch.core.config import T2VArgs
from t2v_torch.core.dtypes import Policy
from t2v_torch.io import convert, train_state
from t2v_torch.pipeline import pipeline as tpipeline
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from t2v_torch.text.tokenizer import CLIPTokenizer
from _torch_model_dir import (
    CLIP_CFG,
    UNET_CFG,
    VAE_CFG,
    VOCAB,
    configuration,
    source_pipeline,
    write_model_dir,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

J_CLIP_CFG = dataclasses.replace(JClipCfg.vit_h_14().tiny(), width=UNET_CFG.context_dim)
PROMPTS = [
    "a photo of a cat in the forest",
    "a (bunny:1.3) on a [snowy] hill, masterpiece",
    "cafÃ© au lait — naïve façade, “quoted” text",    # mojibake, then typographic quotes
    "Ä© stays, emoji 🐱 too, 東京 at night",
    " ".join(["the quick brown fox jumps over the lazy dog"] * 12),   # a long prompt
    "it's, we've, they'll; 3.14159 & <|endoftext|>",
]


@pytest.fixture(scope="module")
def source():
    return source_pipeline()


@pytest.fixture(scope="module")
def model_dir(source, tmp_path_factory):
    return write_model_dir(source, tmp_path_factory.mktemp("modelscope"))


def _load(model_dir, policy=Policy.fp32()):
    return ModelScopePipeline.from_model_dir(str(model_dir), policy, vae_cfg=VAE_CFG,
                                             clip_cfg=CLIP_CFG, device="cpu")


def _state_dicts(pipe):
    return [m.state_dict() for m in (pipe.unet, pipe.vae, pipe.text_encoder.model)]


def _assert_same_weights(a, b):
    for sa, sb in zip(_state_dicts(a), _state_dicts(b)):
        assert sa.keys() == sb.keys()
        bad = [k for k in sa if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k])]
        assert bad == [], bad[:5]


def test_vocab_file_tokenizer_matches_jax(tmp_path):
    mine, theirs = CLIPTokenizer.from_vocab_file(str(VOCAB)), JTokenizer.from_vocab_file(str(VOCAB))
    assert mine.vocab_size == theirs.vocab_size > 512 and mine.source_path == theirs.source_path
    for prompt in PROMPTS:
        ids = mine.encode(prompt)
        assert ids == theirs.encode(prompt), prompt
        assert mine.decode(ids) == theirs.decode(ids)
    assert mine.decode(mine.encode("a photo of a cat")) == "a photo of a cat"
    # the same search order: the .gz name first, directory by directory
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    shutil.copy(VOCAB, tmp_path / "b" / "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(VOCAB, "rb") as f:
        (tmp_path / "a" / "bpe_simple_vocab_16e6.txt").write_bytes(f.read())
    dirs = (str(tmp_path / "none"), str(tmp_path / "a"), str(tmp_path / "b"))
    assert (CLIPTokenizer.find_and_load(*dirs).source_path
            == JTokenizer.find_and_load(*dirs).source_path
            == str(tmp_path / "a" / "bpe_simple_vocab_16e6.txt"))
    with pytest.raises(FileNotFoundError) as e1:
        CLIPTokenizer.find_and_load(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError) as e2:
        JTokenizer.find_and_load(str(tmp_path / "none"))
    assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("ta", ["True", "False", True, False])
def test_configuration_json_matches_jax(tmp_path, ta):
    (tmp_path / "configuration.json").write_text(json.dumps(configuration(UNET_CFG, ta)))
    mine = tconfig.ModelScopeUNetConfig.from_configuration_json(str(tmp_path))
    theirs = JCfg.from_configuration_json(str(tmp_path))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.temporal_attention is (ta in ("True", True))
    # the output options are the JAX package's, field for field
    assert dataclasses.asdict(tconfig.T2VOutputArgs()) == dataclasses.asdict(JOutputArgs())
    assert tconfig.config_from_dict(tconfig.ModelScopeUNetConfig,
                                    json.loads(json.dumps(dataclasses.asdict(mine)))) == mine


def test_from_model_dir_matches_jax(source, model_dir, tmp_path):
    """float32 files, then a float16 UNet file beside the same VAE and text
    tower: the port's pipeline equals ``from_jax`` of the JAX package's
    loaded trees bit for bit; the float32 one also equals the source."""
    half = tmp_path / "fp16"
    shutil.copytree(model_dir, half)
    torch.save({k: v.half() for k, v in source.unet.state_dict().items()},
               half / "text2video_pytorch_model.pth")
    for d in (model_dir, half):
        theirs = jpipeline.ModelScopePipeline.from_model_dir(
            str(d), JPolicy.fp32(), vae_cfg=JVAECfg().tiny(), clip_cfg=J_CLIP_CFG)
        leaves = [jax.tree.map(np.asarray, t) for t in
                  (theirs.unet_params, theirs.vae_params, theirs.text_encoder.params)]
        want = ModelScopePipeline.from_jax(*leaves, UNET_CFG, device="cpu", vae_cfg=VAE_CFG,
                                           clip_cfg=CLIP_CFG)
        mine = _load(d)
        _assert_same_weights(mine, want)
        assert mine.model_dir == str(d) and mine.clip_cfg == CLIP_CFG
        assert mine.text_encoder.tokenizer.vocab_size == theirs.text_encoder.tokenizer.vocab_size
    _assert_same_weights(_load(model_dir), source)
    # every key the module owns must be in the file
    sd = torch.load(half / "text2video_pytorch_model.pth")
    sd.pop("out.2.bias")
    torch.save(sd, half / "text2video_pytorch_model.pth")
    with pytest.raises(KeyError, match="out.2.bias"):
        _load(half)


def test_from_native_loads_what_save_weights_wrote(source, tmp_path):
    out = train_state.save_weights(
        str(tmp_path / "native"), unet_params=dict(source.unet.named_parameters()),
        vae=source.vae, clip=source.text_encoder.model, unet_cfg=source.unet_cfg,
        vae_cfg=source.vae_cfg, clip_cfg=source.clip_cfg, model_family="modelscope",
        tokenizer_vocab=str(VOCAB))
    assert train_state.is_native_checkpoint(out)
    # detected by from_model_dir; the configs come from t2v_torch.json
    mine = ModelScopePipeline.from_model_dir(out, Policy.fp32(), device="cpu")
    _assert_same_weights(mine, source)
    assert (mine.unet_cfg, mine.vae_cfg, mine.clip_cfg) == (UNET_CFG, VAE_CFG, CLIP_CFG)
    assert mine.text_encoder.tokenizer.source_path.startswith(out)
    mine.release_aux()
    mine.reload_aux()
    _assert_same_weights(mine, source)
    bf16 = ModelScopePipeline.from_native(out, Policy.bf16(), device="cpu")
    assert {p.dtype for p in bf16.unet.parameters()} == {torch.bfloat16}
    meta = json.loads((tmp_path / "native" / "t2v_torch.json").read_text())
    meta["model_family"] = "videocrafter"
    (tmp_path / "native" / "t2v_torch.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="videocrafter"):
        ModelScopePipeline.from_native(out, device="cpu")


def _stable_lora(rng, pipe):
    """A stable-lora state dict over the first UNet module of each layout
    kind and two text-tower linears, with bias deltas, and one name no
    index knows. Returns (state dict, names of the weights and biases it
    changes)."""
    from t2v_torch.pipeline.lora import text_module_index, unet_module_index

    unet_index = list(unet_module_index(UNET_CFG).items())
    picks = [next((n, pk) for n, pk in unet_index if pk[1] == kind)
             for kind in ("linear", "conv2d", "conv3d", "conv1d")]
    picks += list(text_module_index(CLIP_CFG).items())[:2]
    params = {**pipe.unet.state_dict(), **pipe.text_encoder.model.state_dict()}
    sd, changed = {}, []
    for name, (pname, kind) in picks:
        w = params[pname]
        # a conv delta is (out, in * kh * kw); the temporal (3, 1, 1) conv's
        # is the 2-D (3, 3) delta that the merge mean-collapses
        d_in = w.shape[1] * w.shape[2] ** 2 if kind == "conv3d" else int(np.prod(w.shape[1:]))
        sd[f"{name}.lora_A"] = rng.normal(size=(2, d_in)).astype(np.float32)
        sd[f"{name}.lora_B"] = rng.normal(size=(w.shape[0], 2)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(size=(w.shape[0],)).astype(np.float32)
        changed += [pname, pname.removesuffix("weight") + "bias"]
    sd["not.a.module.lora_A"] = np.zeros((2, 4), np.float32)
    sd["not.a.module.lora_B"] = np.zeros((4, 2), np.float32)
    return sd, changed


def test_apply_stable_lora_matches_jax(model_dir):
    mine = _load(model_dir)
    theirs = jpipeline.ModelScopePipeline.from_model_dir(
        str(model_dir), JPolicy.fp32(), vae_cfg=JVAECfg().tiny(), clip_cfg=J_CLIP_CFG)
    lora, names = _stable_lora(np.random.default_rng(4), mine)
    before = {**mine.unet.state_dict(), **mine.text_encoder.model.state_dict()}
    before = {k: v.clone() for k, v in before.items()}
    mine.text_encoder.encode_line("a cat")
    skipped = mine.apply_stable_lora(lora, 0.7)
    assert mine.text_encoder._cache == {}
    assert skipped == theirs.apply_stable_lora(lora, 0.7)
    assert "not.a.module" in skipped["unet"] and "not.a.module" in skipped["clip"]
    want = {
        **convert.from_jax_unet(jax.tree.map(np.asarray, theirs.unet_params), UNET_CFG),
        **convert.from_jax_clip(jax.tree.map(np.asarray, theirs.text_encoder.params), CLIP_CFG),
    }
    after = {**mine.unet.state_dict(), **mine.text_encoder.model.state_dict()}
    assert sorted(k for k in after if not torch.equal(after[k], before[k])) == sorted(names)
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[k]).max())
    mine.apply_stable_lora(lora, 0.7, undo=True)
    after = {**mine.unet.state_dict(), **mine.text_encoder.model.state_dict()}
    for k, v in after.items():
        torch.testing.assert_close(v, before[k], rtol=1e-6, atol=1e-6)


def test_load_pipeline_cache_and_hot_switch_match_jax(monkeypatch, tmp_path):
    """The same sequence of loads through both packages' ``load_pipeline``
    (their ``from_model_dir`` stood in for by a recorder) loads, reuses and
    drops the same pipelines."""
    def recorder(pkg, calls):
        def fake(cls, model_dir, policy, **kw):
            calls.append(model_dir)
            return (pkg, model_dir, len(calls))
        return classmethod(fake)

    monkeypatch.setattr(jpipeline, "_PIPELINE_CACHE", {})
    monkeypatch.setattr(tpipeline, "_PIPELINE_CACHE", {})
    monkeypatch.setattr("t2v.core.compile_cache.enable_compile_cache", lambda *a, **k: None)
    traces = []
    for mod, kw in ((jpipeline, {}), (tpipeline, {"device": "cpu"})):
        calls = []
        monkeypatch.setattr(mod.ModelScopePipeline, "from_model_dir", recorder(mod, calls))
        a, b, c = (str(tmp_path / n) for n in "abc")
        seq = [mod.load_pipeline(a, **kw), mod.load_pipeline(a, **kw), mod.load_pipeline(b, **kw),
               mod.load_pipeline(tmp_path / "b", **kw), mod.load_pipeline(a, **kw),
               mod.load_pipeline(c, keep_in_vram=False, **kw),
               mod.load_pipeline(c, keep_in_vram=False, **kw), mod.load_pipeline(a, **kw),
               mod.load_pipeline(a, keep_in_vram=False, **kw)]
        traces.append(([s[2] for s in seq], calls, len(mod._PIPELINE_CACHE)))
    assert traces[0] == traces[1]
    assert traces[1][0] == [1, 1, 2, 2, 3, 4, 5, 6, 6] and traces[1][2] == 1


def test_release_and_reload_give_the_same_frames(model_dir, tmp_path):
    """'Main Model Only' through ``run``: the VAE and text tower are gone
    after each request and read again before the next; the frames are
    the same."""
    from t2v_torch.core.config import T2VOutputArgs
    from t2v_torch.pipeline import run as run_mod

    pipe = _load(model_dir)
    unet = pipe.unet
    frames = []
    infer = pipe.infer

    def recording(*a, **k):
        res = infer(*a, **k)
        frames.append(res.frames)
        return res

    pipe.infer = recording
    args = T2VArgs(prompt="a cat", steps=2, frames=2, width=32, height=32, seed=3, cfg_scale=9.0)
    out = T2VOutputArgs(skip_video_creation=True)
    saved = run_mod._warm_pipe
    try:
        for _ in range(2):
            run_mod.run(args, out, pipe=pipe, outdir=str(tmp_path), save_frames=False,
                        keep_in_vram="Main Model Only")
            assert pipe.vae is None and pipe.text_encoder is None and pipe.unet is unet
            assert run_mod._warm_pipe is pipe
    finally:
        run_mod._warm_pipe = saved
    assert len(frames) == 2 and np.array_equal(frames[0], frames[1]) and frames[0].std() > 0
    with pytest.raises(ValueError, match="reload_aux"):
        pipe.infer(args)
    random = source_pipeline()
    random.release_aux()
    with pytest.raises(ValueError, match="no model_dir"):
        random.reload_aux()
