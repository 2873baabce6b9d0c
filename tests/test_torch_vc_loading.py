"""The port's VideoCrafter loading against the JAX package's, on a tiny
directory in the published layout (``tests/_torch_model_dir.py``: a
Lightning ``model.ckpt`` beside its ``model_config.yaml`` and the vocab):
the YAML subset reader against ``yaml.safe_load``, ``io/convert_vc.py``,
``from_checkpoint`` / ``from_native`` / ``from_model_dir``, ``load_lora``,
'Main Model Only', ``run``, the CLI, the API and the trainer's
``--vc-ckpt``, loading VideoCrafter by name.

Tolerances: configs, split keys, index order and loaded weights exactly
(the same stored float32 values on both sides; a bf16 load bit-identical to
the source's bf16 cast); the text encoding rtol = atol = 2e-4; latents 1e-3
absolute and relative; frames within one uint8 level (float32 on both
sides, another summation order); LVDM merges within 1e-6 (float32 products
summed in another order); frames of the same weights on the same device
exactly.
"""

import dataclasses
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from t2v.core.dtypes import Policy as JPolicy
from t2v.diffusion.sampling import sample_loop as j_sample_loop
from t2v.io.convert import convert_vae
from t2v.io.convert_vc import convert_vc_unet
from t2v.io.convert_vc import split_lightning_state_dict as j_split
from t2v.io.convert_vc import vc_module_index as j_vc_module_index
from t2v.models.videocrafter_unet import VideoCrafterUNetConfig as JCfg
from t2v.pipeline.lora import merge_lvdm_lora as j_merge_lvdm_lora
from t2v.pipeline.videocrafter import VideoCrafterPipeline as JPipeline
from t2v.text.clip import convert_hf_clip_text
from t2v_torch.core.config import T2VArgs, T2VOutputArgs, VAEConfig, VideoCrafterUNetConfig
from t2v_torch.core.dtypes import Policy
from t2v_torch.io import train_state, yaml_lite
from t2v_torch.io.convert_vc import split_lightning_state_dict, vc_module_index
from t2v_torch.io.safetensors_io import save_safetensors
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet
from t2v_torch.pipeline import pipeline as tpipeline
from t2v_torch.pipeline.lora import merge_lvdm_lora
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
from _torch_model_dir import (
    VC_UNET_CFG,
    VOCAB,
    source_pipeline,
    vc_model_config,
    vc_source_pipeline,
    write_clip_dir,
    write_model_dir,
    write_vc_dir,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
ARGS = dict(prompt="a cat in the forest", n_prompt="blurry, text", steps=2, frames=4, width=16,
            height=16, cfg_scale=9.0, seed=11)


@pytest.fixture(scope="module")
def vc_dir(tmp_path_factory):
    """(source pipeline, directory, its noise) of the module's tests."""
    src = vc_source_pipeline()
    out = write_vc_dir(src, tmp_path_factory.mktemp("vc") / "VideoCrafter")
    noise = np.random.default_rng(0).normal(size=(1, 4, 8, 8, 4)).astype(np.float32)
    return src, out, noise


@pytest.fixture
def caches_reset():
    """``run`` and the loaders keep module-level state: restore it."""
    from t2v_torch.pipeline import run as run_mod

    saved = run_mod._warm_pipe
    yield run_mod
    run_mod._warm_pipe = saved
    tpipeline._PIPELINE_CACHE.clear()


def _same_modules(a, b, dtype=None) -> None:
    for ma, mb in zip((a.unet, a.vae, a.clip), (b.unet, b.vae, b.clip)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            want = sb[k] if dtype is None else sb[k].to(dtype)
            assert sa[k].dtype == want.dtype and torch.equal(sa[k], want), k


def _np(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _tree_equal(got, want) -> None:
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    mine = dict(jax.tree_util.tree_leaves_with_path(got))
    assert mine.keys() == flat.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(mine[path], np.float32),
                                      np.asarray(leaf, np.float32))


def test_yaml_reader_matches_pyyaml_and_refuses_the_rest(tmp_path):
    """The published layout, its FPS variant and the JAX package's
    ``cond_stage2_config`` dict dumped by PyYAML read the same through both
    readers and parse into equal configs in both packages; text outside the
    subset raises with its line."""
    jax_variant = {"model": {"params": {
        "unet_config": {"params": {"in_channels": 4, "out_channels": 4, "model_channels": 32,
                                   "num_res_blocks": 1, "attention_resolutions": [1],
                                   "channel_mult": [1, 2], "num_heads": 2, "context_dim": 32}},
        "cond_stage2_config": {"target": "lvdm...FPSEmbedder"}}}}
    texts = [vc_model_config(VideoCrafterUNetConfig(), VAEConfig()),
             vc_model_config(VC_UNET_CFG, VAEConfig().tiny(), fps=True),
             yaml.safe_dump(jax_variant),
             "---\na: [1, 2.5, 1e-4, '3', \"x # y\", ~, off, 'it''s', a'b]  # tail\nb:\n"
             "- 1\n- 'q # r'\n-  x y\nc:\n"]
    for text in texts:
        want = yaml.safe_load(text)
        assert yaml_lite.safe_load(text) == want, text
        if "model" in want:
            mine = VideoCrafterUNetConfig.from_yaml_dict(want)
            assert dataclasses.asdict(mine) == dataclasses.asdict(JCfg.from_yaml_dict(want))
    published = yaml_lite.safe_load(texts[0])
    assert VideoCrafterUNetConfig.from_yaml_dict(published) == VideoCrafterUNetConfig()
    assert VAEConfig.from_yaml_dict(published) == VAEConfig()
    assert VAEConfig.from_yaml_dict(yaml_lite.safe_load(texts[1])) == VAEConfig().tiny()
    assert VideoCrafterUNetConfig.from_yaml_dict(yaml_lite.safe_load(texts[2])).cond_stage2_key \
        == "temporal_context"
    for bad, what in [("a: &x 1\nb: *x", "line 1"), ("a: |\n  text", "block scalars"),
                      ("a:\n\tb: 1", "tab"), ("a: 1\na: 2", "duplicate key"),
                      ("a: 0x1F", "number form"), ("a: [1,\n  2]", "multi-line"),
                      ("a: 1\n---\nb: 2", "more than one document"), ("a: !!str 1", "line 1"),
                      ("a: 1:30", "number form"), ("a: 'open", "unterminated"),
                      ("a: {b: 1}", "line 1"), ("a: [[1], 2]", "nested flow"),
                      ("a:\n- b: 1", "nested collection"), ("a:\n- - 1", "nested collection"),
                      ("a: .inf", "number form"), ("a: 2001-12-14", "number form"),
                      ('a: "x\\ty"', "quoted string"), ("'a': 1", "plain key"),
                      ("a: b\n  c", "indentation")]:
        with pytest.raises(yaml_lite.YAMLSubsetError, match=what):
            yaml_lite.safe_load(bad)


def test_convert_vc_matches_jax(vc_dir):
    """The Lightning split, the LoRA index (names and order) and the key
    sets: the JAX converter reads every key of the port's UNet state dict
    and nothing else, so loading is the prefix strip alone."""
    src, _, _ = vc_dir
    ckpt = {"state_dict": {"model.diffusion_model.out.0.weight": np.zeros(2),
                           "first_stage_model.encoder.conv_in.weight": np.ones(2),
                           "cond_stage_model.transformer.text_model.final_layer_norm.weight":
                               np.zeros(3),
                           "model_ema.decay": np.zeros(1)}, "global_step": 5}
    mine, theirs = split_lightning_state_dict(ckpt), j_split(ckpt)
    assert {k: sorted(v) for k, v in mine.items()} == {k: sorted(v) for k, v in theirs.items()}
    for cfg in (VideoCrafterUNetConfig(), VC_UNET_CFG):
        jcfg = JCfg(**dataclasses.asdict(cfg))
        idx = vc_module_index(cfg)
        assert list(idx) == list(j_vc_module_index(jcfg))
        assert {v for v in idx.values()} == {(f"{n}.weight", "linear") for n in idx}
    sd = _np(src.unet)
    touched = set()

    class Recording(dict):
        def __getitem__(self, k):
            touched.add(k)
            return dict.__getitem__(self, k)

        def __contains__(self, k):
            touched.add(k)
            return dict.__contains__(self, k)

    convert_vc_unet(Recording(sd), JCfg(**dataclasses.asdict(VC_UNET_CFG)))
    assert touched >= set(sd)
    with torch.device("meta"):
        full = VideoCrafterUNet(VideoCrafterUNetConfig()).state_dict()
    assert all(name in full for name, _ in vc_module_index(VideoCrafterUNetConfig()).values())


def test_from_checkpoint_matches_jax(vc_dir):
    """Both packages load the same ``model.ckpt``: the same weights, the
    same text encoding, and the same latents and frames from the same noise
    (2 DDIM steps, CFG 9); a bf16 load is the source's bf16 cast."""
    src, model_dir, noise = vc_dir
    pipe = VideoCrafterPipeline.from_model_dir(str(model_dir), Policy.fp32(), device="cpu")
    _same_modules(pipe, src)
    assert pipe.ckpt_path == str(model_dir / "model.ckpt") and pipe.model_dir is None
    assert pipe.clip_cfg == src.clip_cfg and pipe.vae_cfg == src.vae_cfg
    assert pipe.cfg == VC_UNET_CFG and pipe.tokenizer.source_path.endswith(".txt.gz")
    half = VideoCrafterPipeline.from_checkpoint(str(model_dir / "model.ckpt"), policy=Policy.bf16(),
                                                device="cpu")
    _same_modules(half, src, torch.bfloat16)
    del half

    jpipe = JPipeline.from_checkpoint(str(model_dir / "model.ckpt"), policy=JPolicy.fp32())
    assert dataclasses.asdict(jpipe.cfg) == dataclasses.asdict(pipe.cfg)
    jcfg, jvae_cfg, jclip_cfg = jpipe.cfg, jpipe.vae_cfg, jpipe.clip_cfg
    _tree_equal(convert_vc_unet(_np(pipe.unet), jcfg), jpipe.unet_params)
    _tree_equal(convert_vae(_np(pipe.vae), jvae_cfg), jpipe.vae_params)
    _tree_equal(convert_hf_clip_text(_np(pipe.clip), jclip_cfg), jpipe.clip_params)

    cond = jpipe.encode_text([ARGS["prompt"]])
    np.testing.assert_allclose(pipe.encode_text([ARGS["prompt"]]).numpy(), np.asarray(cond), **TOL)
    want_lat = j_sample_loop(
        jpipe.make_apply_fn(), jpipe.schedule, steps=2, shape=noise.shape, cond=cond,
        uncond=jpipe.encode_text([ARGS["n_prompt"]]), guidance_scale=9.0, sampler_name="DDIM",
        noise=jnp.asarray(noise))
    want_frames = jpipe.decode_latents(want_lat[0])
    res = pipe.infer(T2VArgs(**ARGS, sampler="DDIM"), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(res.latents.numpy(), np.asarray(want_lat), rtol=1e-3, atol=1e-3)
    assert np.abs(res.frames.astype(int) - want_frames.astype(int)).max() <= 1


def test_from_native_from_model_dir_and_refusals(vc_dir, tmp_path):
    """The trainer's layout round-trips through ``from_model_dir`` and
    keeps its family; an FPS-conditioned config over a checkpoint without
    ``cond_stage2_model`` weights loads a fresh embedder with a warning and
    then needs ``cond_fps``; a checkpoint that pickles a non-tensor global
    and a directory of the other family are refused by name (the JAX reader
    refuses the same global)."""
    src, model_dir, _ = vc_dir
    saved = train_state.save_weights(
        str(tmp_path / "native"), unet_params=dict(src.unet.named_parameters()), vae=src.vae,
        clip=src.clip, unet_cfg=src.cfg, vae_cfg=src.vae_cfg, clip_cfg=src.clip_cfg,
        model_family="videocrafter", tokenizer_vocab=str(VOCAB))
    pipe = VideoCrafterPipeline.from_model_dir(saved, Policy.fp32(), device="cpu")
    _same_modules(pipe, src)
    assert pipe.model_dir == saved and pipe.ckpt_path is None
    args = T2VArgs(**ARGS)
    np.testing.assert_array_equal(pipe.infer(args).frames, src.infer(args).frames)
    with pytest.raises(ValueError, match="videocrafter checkpoint"):
        tpipeline.ModelScopePipeline.from_native(saved, Policy.fp32(), device="cpu")
    ms = write_model_dir(source_pipeline(), tmp_path / "ms")
    ms_saved = train_state.save_weights(
        str(tmp_path / "ms_native"), unet_params={}, vae=src.vae, clip=src.clip,
        unet_cfg=src.cfg, vae_cfg=src.vae_cfg, clip_cfg=src.clip_cfg, model_family="modelscope")
    with pytest.raises(ValueError, match="modelscope checkpoint"):
        VideoCrafterPipeline.from_native(ms_saved, Policy.fp32(), device="cpu")
    with pytest.raises(FileNotFoundError, match="model_config.yaml"):
        VideoCrafterPipeline.from_model_dir(str(ms), Policy.fp32(), device="cpu")

    fps = tmp_path / "fps"
    fps.mkdir()
    for name in ("model.ckpt", "bpe_simple_vocab_16e6.txt.gz"):
        (fps / name).symlink_to(model_dir / name)
    (fps / "model_config.yaml").write_text(vc_model_config(src.cfg, src.vae_cfg, fps=True))
    with pytest.warns(UserWarning, match="FPS-conditioned .*no compatible cond_stage2_model"):
        fps_pipe = VideoCrafterPipeline.from_model_dir(str(fps), Policy.fp32(), device="cpu")
    assert fps_pipe.fps_embedder is not None
    with pytest.raises(ValueError, match="FPS-conditioned: set cond_fps"):
        fps_pipe.infer(args)
    assert fps_pipe.infer(args.replace(cond_fps=8)).frames.shape == src.infer(args).frames.shape
    pickled = tmp_path / "pickled"
    pickled.mkdir()
    (pickled / "model_config.yaml").write_text(vc_model_config(src.cfg, src.vae_cfg))
    torch.save({"state_dict": {}, "hyper_parameters": argparse_namespace()},
               pickled / "model.ckpt")
    with pytest.raises(ValueError, match="pickles argparse.Namespace"):
        VideoCrafterPipeline.from_model_dir(str(pickled), Policy.fp32(), device="cpu")
    with pytest.raises(Exception, match="argparse.Namespace"):
        JPipeline.from_checkpoint(str(pickled / "model.ckpt"), policy=JPolicy.fp32())


def argparse_namespace():
    import argparse

    return argparse.Namespace(lr=1e-4)


def test_load_lora_matches_the_cpu_sum_and_jax(vc_dir, tmp_path):
    """An LVDM LoRA (rank 4, conv-shaped factors on one target, a name no
    module has, a torch file under ``state_dict``) merges as
    ``W + scale * up @ down``, as the JAX package merges it."""
    src, model_dir, _ = vc_dir
    rng = np.random.default_rng(3)
    idx = vc_module_index(VC_UNET_CFG)
    names = list(idx)[::9]
    base = {k: v.clone() for k, v in src.unet.state_dict().items()}
    sd = {}
    for i, name in enumerate(names):
        d_out, d_in = base[f"{name}.weight"].shape
        up = rng.normal(size=(d_out, 4)).astype(np.float32)
        down = rng.normal(size=(4, d_in)).astype(np.float32)
        sd[f"{name}.lora_up.weight"] = up[:, :, None, None] if i == 0 else up
        sd[f"{name}.lora_down.weight"] = down[:, :, None, None] if i == 0 else down
    sd["nowhere.lora_up.weight"] = sd["nowhere.lora_down.weight"] = np.ones((1, 1), np.float32)
    path = save_safetensors(str(tmp_path / "lvdm.safetensors"), sd)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "lvdm.pt")
    want_tree, j_skipped = j_merge_lvdm_lora(
        convert_vc_unet(_np(src.unet), JCfg(**dataclasses.asdict(VC_UNET_CFG))), sd,
        j_vc_module_index(JCfg(**dataclasses.asdict(VC_UNET_CFG))), 0.75)
    for lora_file in (path, str(tmp_path / "lvdm.pt")):
        pipe = VideoCrafterPipeline.from_model_dir(str(model_dir), Policy.fp32(), device="cpu")
        assert pipe.load_lora(lora_file, 0.75) == j_skipped == ["nowhere"]
        got = pipe.unet.state_dict()
        for name in names:
            up, down = (sd[f"{name}.lora_{s}.weight"].reshape(-1, sd[f"{name}.lora_{s}.weight"]
                        .shape[1]) for s in ("up", "down"))
            want = base[f"{name}.weight"] + 0.75 * torch.from_numpy(up @ down)
            torch.testing.assert_close(got[f"{name}.weight"], want, rtol=1e-6, atol=1e-6)
        assert all(torch.equal(got[k], base[k]) for k in base
                   if k.removesuffix(".weight") not in names)
        _tree_equal_close(convert_vc_unet(_np(pipe.unet), JCfg(**dataclasses.asdict(VC_UNET_CFG))),
                          want_tree)
    params, skipped = merge_lvdm_lora(base, {}, idx)
    assert skipped == [] and all(params[k] is base[k] for k in base)


def _tree_equal_close(got, want) -> None:
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat[path]), rtol=1e-6, atol=1e-6)


def test_release_and_reload_aux(vc_dir):
    """'Main Model Only' on a Lightning checkpoint: the UNet stays, the VAE
    and text tower go and come back bit-identical; a random-init pipeline
    cannot reload."""
    src, model_dir, _ = vc_dir
    pipe = VideoCrafterPipeline.from_model_dir(str(model_dir), Policy.fp32(), device="cpu")
    args = T2VArgs(**ARGS)
    before = pipe.infer(args).frames
    unet = pipe.unet
    pipe.release_aux()
    assert pipe.vae is None and pipe.clip is None and pipe.unet is unet
    with pytest.raises(ValueError, match="reload_aux"):
        pipe.infer(args)
    pipe.reload_aux()
    _same_modules(pipe, src)
    np.testing.assert_array_equal(pipe.infer(args).frames, before)
    fresh = VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu")
    fresh.release_aux()
    with pytest.raises(ValueError, match="Main Model Only"):
        fresh.reload_aux()


def test_run_cli_and_api_load_videocrafter_by_name(vc_dir, tmp_path, monkeypatch, caches_reset,
                                                   capsys):
    """``run`` loads a VideoCrafter model by name (``model_type``, and
    '<videocrafter>' implying it), the hot switch drops the other family's
    cached pipeline, 'Main Model Only' releases and reloads; the CLI takes
    ``--model-type VideoCrafter --model-dir`` (a directory or the .ckpt,
    with an LVDM ``--lora``) and the API a ``model_type`` request. Every
    answer's frames equal the source pipeline's."""
    pytest.importorskip("cv2")
    from t2v_torch.api.stdlib_server import serve
    from t2v_torch.cli.generate import main

    src, model_dir, _ = vc_dir
    run = caches_reset.run
    root = tmp_path / "models"
    (root / "text2video").mkdir(parents=True)
    os.symlink(model_dir, root / "VideoCrafter")
    os.symlink(model_dir, root / "text2video" / "vc")
    ms = source_pipeline()  # in the trainer's layout, which records its small configs
    train_state.save_weights(
        str(root / "text2video" / "ms"), unet_params=dict(ms.unet.named_parameters()),
        vae=ms.vae, clip=ms.text_encoder.model, unet_cfg=ms.unet_cfg, vae_cfg=ms.vae_cfg,
        clip_cfg=ms.clip_cfg, model_family="modelscope", tokenizer_vocab=str(VOCAB))
    monkeypatch.setenv("T2V_MODELS_ROOT", str(root))
    monkeypatch.chdir(tmp_path)
    args = T2VArgs(**ARGS, model_type="VideoCrafter", model="vc")
    want = src.infer(args).frames
    out = T2VOutputArgs(skip_video_creation=True)

    def frames(result):
        import cv2

        d = result.frame_dirs[0]
        return np.stack([cv2.cvtColor(cv2.imread(os.path.join(d, f)), cv2.COLOR_BGR2RGB)
                         for f in sorted(os.listdir(d)) if f.endswith(".png")])

    np.testing.assert_array_equal(frames(run(args, out, outdir=str(tmp_path / "a"),
                                             device="cpu")), want)
    pipe = caches_reset._warm_pipe
    assert isinstance(pipe, VideoCrafterPipeline) and list(tpipeline._PIPELINE_CACHE.values()) == [pipe]
    ms_args = T2VArgs(prompt="a cat", steps=1, frames=2, width=32, height=32, seed=1, model="ms")
    run(ms_args, out, outdir=str(tmp_path / "b"), device="cpu")
    assert [key[0] for key in tpipeline._PIPELINE_CACHE] == ["modelscope"]
    res = run(args.replace(model="<videocrafter>", model_type="ModelScope"), out,
              outdir=str(tmp_path / "c"), device="cpu", keep_in_vram="Main Model Only")
    np.testing.assert_array_equal(frames(res), want)
    pipe = caches_reset._warm_pipe
    assert list(tpipeline._PIPELINE_CACHE.values()) == [pipe] and pipe.vae is None \
        and pipe.clip is None
    res = run(args.replace(model=None), out, outdir=str(tmp_path / "d"), device="cpu",
              keep_in_vram="Main Model Only")
    np.testing.assert_array_equal(frames(res), want)
    assert caches_reset._warm_pipe is pipe and pipe.vae is None

    lora = save_safetensors(str(tmp_path / "l.safetensors"), {
        f"{name}.lora_{s}.weight": np.full(shape, 0.05, np.float32)
        for name in list(vc_module_index(VC_UNET_CFG))[:4]
        for s, shape in (("up", (32, 2)), ("down", (2, 32)))})
    cli = ["--model-type", "VideoCrafter", "--prompt", ARGS["prompt"], "--n-prompt",
           ARGS["n_prompt"], "--steps", "2", "--frames", "4", "--width", "16", "--height", "16",
           "--cfg-scale", "9", "--seed", "11", "--device", "cpu", "--skip-video-creation"]
    assert main([*cli, "--model-dir", str(model_dir), "--outdir", str(tmp_path / "e")]) == 0
    assert main([*cli, "--model-dir", str(model_dir / "model.ckpt"), "--lora", lora,
                 "--outdir", str(tmp_path / "f")]) == 0
    assert "merged LVDM LoRA l.safetensors (skipped 0)" in capsys.readouterr().out
    got = [frames(type("R", (), {"frame_dirs": [str(next((tmp_path / d).iterdir()))]}))
           for d in ("e", "f")]
    np.testing.assert_array_equal(got[0], want)
    assert not np.array_equal(got[1], want)

    srv = serve(port=0, block=False, device="cpu")
    try:
        host, port = srv.server_address
        q = ("prompt=a+cat+in+the+forest&n_prompt=blurry%2C+text&model_type=VideoCrafter"
             "&model=vc&steps=2&frames=4&width=16&height=16&cfg_scale=9&seed=11")
        req = urllib.request.Request(f"http://{host}:{port}/t2v/run?{q}", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and json_mp4s(r.read())[0].startswith("data:video/mp4")
    finally:
        srv.shutdown()
        srv.server_close()
    assert isinstance(caches_reset._warm_pipe, VideoCrafterPipeline)
    api_dir = sorted((tmp_path / "outputs" / "text2video").iterdir())[-1]
    np.testing.assert_array_equal(frames(type("R", (), {"frame_dirs": [str(api_dir)]})), want)


def json_mp4s(body: bytes) -> list:
    import json

    return json.loads(body)["mp4s"]


def test_trainer_fine_tunes_a_vc_checkpoint(vc_dir, tmp_path, capsys):
    """``--model-type VideoCrafter --vc-ckpt`` trains one full step from the
    Lightning checkpoint and saves a directory that loads as VideoCrafter
    with the family recorded; ``--model-dir`` takes the same directory."""
    pytest.importorskip("cv2")
    from t2v_torch.cli import train as cli

    src, model_dir, _ = vc_dir
    write_clip_dir(tmp_path / "data")
    common = ["--data-dir", str(tmp_path / "data"), "--model-type", "VideoCrafter", "--device",
              "cpu", "--batch-size", "1", "--frames", "4", "--resolution", "32", "--steps", "1",
              "--log-every", "1"]
    assert cli.main([*common, "--vc-ckpt", str(model_dir / "model.ckpt"),
                     "--out", str(tmp_path / "out")]) == 0
    assert "step 1 loss" in capsys.readouterr().out
    saved = tmp_path / "out" / "step_1"
    meta, _ = train_state.load_weights(str(saved), only=())
    assert meta["model_family"] == "videocrafter"
    pipe = VideoCrafterPipeline.from_model_dir(str(saved), Policy.fp32(), device="cpu")
    trained, before = pipe.unet.state_dict(), src.unet.state_dict()
    assert any(not torch.equal(trained[k], before[k]) for k in before)
    assert all(torch.equal(a, b) for a, b in zip(pipe.clip.state_dict().values(),
                                                 src.clip.state_dict().values()))
    assert cli.main([*common, "--model-dir", str(saved), "--out", str(tmp_path / "out2")]) == 0
