"""The port's user surface against the JAX package's: the job runner
(``pipeline/run.py``) on one tiny model directory in both packages, the
generation CLI, the MP4 metadata reader, the API handlers' payloads and
error shapes, one stdlib-server request over a socket, the FastAPI app
through ``tests/_fastapi_stub.py``, and what the port refuses by name.

Tolerances: the end-to-end run's PNG frames within one level (float32 on
both sides, another summation order, decoded to uint8) and its ``args.txt``
and infotexts equal; handler payloads, parsed requests and the metadata
comment exactly.
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from t2v_torch.core.config import T2VArgs, T2VOutputArgs
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from _torch_model_dir import CLIP_CFG, VAE_CFG, source_pipeline, write_model_dir
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def tiny_pipe():
    return ModelScopePipeline.random_init(device="cpu")


@pytest.fixture
def warm_pipe_reset():
    """``run`` keeps the last pipeline in a module global: restore it."""
    from t2v_torch.pipeline import run as run_mod

    saved = run_mod._warm_pipe
    yield run_mod
    run_mod._warm_pipe = saved


def _pngs(d):
    import cv2

    return {f: cv2.imread(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".png")}


def test_run_matches_jax_on_a_model_dir(tmp_path, monkeypatch, warm_pipe_reset):
    """Both packages load the same directory and answer the same request
    (2 DDIM_Gaussian steps, 4 frames at 32x32, CFG 9) through their
    ``run``; the port is handed the JAX package's starting noise."""
    pytest.importorskip("cv2")
    from t2v.core import rng as jrng
    from t2v.core.config import CLIPTextConfig as JClipCfg
    from t2v.core.config import T2VArgs as JArgs
    from t2v.core.config import T2VOutputArgs as JOutputArgs
    from t2v.core.config import VAEConfig as JVAECfg
    from t2v.core.dtypes import Policy as JPolicy
    from t2v.pipeline.pipeline import ModelScopePipeline as JPipeline
    from t2v.pipeline.run import run as jrun
    from t2v_torch.core import rng as trng
    from t2v_torch.core.dtypes import Policy

    d = str(write_model_dir(source_pipeline(), tmp_path / "model"))
    theirs = JPipeline.from_model_dir(d, JPolicy.fp32(), vae_cfg=JVAECfg().tiny(),
                                      clip_cfg=dataclasses.replace(JClipCfg.vit_h_14().tiny(),
                                                                   width=CLIP_CFG.width))
    mine = ModelScopePipeline.from_model_dir(d, Policy.fp32(), vae_cfg=VAE_CFG, clip_cfg=CLIP_CFG,
                                             device="cpu")
    kw = dict(prompt="a (cat:1.2) in the forest", seed=11, steps=2, frames=4, width=32,
              height=32, cfg_scale=9.0)
    noise = np.array(jrng.latent_noise(jrng.key_for_seed(11), (1, 4, 16, 16, 4)))
    monkeypatch.setattr(trng, "latent_noise", lambda gen, shape, dev: torch.from_numpy(noise))
    want = jrun(JArgs(**kw), JOutputArgs(), pipe=theirs, outdir=str(tmp_path / "jax"),
                callback_interval=None)
    got = warm_pipe_reset.run(T2VArgs(**kw), T2VOutputArgs(), pipe=mine,
                              outdir=str(tmp_path / "port"), callback_interval=None)
    assert got.infotexts == want.infotexts and "Seed: 11" in got.infotexts[0]
    a, b = _pngs(got.frame_dirs[0]), _pngs(want.frame_dirs[0])
    assert a.keys() == b.keys() and len(a) == 4
    for name in a:
        assert np.abs(a[name].astype(int) - b[name].astype(int)).max() <= 1, name
    args_txt = [open(os.path.join(r.frame_dirs[0], "args.txt")).read() for r in (got, want)]
    assert args_txt[0] == args_txt[1]
    manifest = json.load(open(os.path.join(got.frame_dirs[0], "manifest.json")))
    assert manifest["seed"] == 11 and manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert got.videos and got.data_urls[0].startswith("data:video/mp4;base64,")


def _stable_lora_file(path, pipe):
    from t2v_torch.io.safetensors_io import save_safetensors
    from t2v_torch.pipeline.lora import METADATA_TAG, unet_module_index

    name, (pname, _) = next((n, v) for n, v in unet_module_index(pipe.unet_cfg).items()
                            if v[1] == "linear")
    d_out, d_in = pipe.unet.state_dict()[pname].shape
    rng = np.random.default_rng(0)
    save_safetensors(str(path), {f"{name}.lora_A": rng.normal(size=(2, d_in)).astype(np.float32),
                                 f"{name}.lora_B": rng.normal(size=(d_out, 2)).astype(np.float32)},
                     {METADATA_TAG: "true"})


def test_cli_writes_an_mp4_on_the_cpu(tmp_path, capsys, warm_pipe_reset, tiny_pipe):
    pytest.importorskip("cv2")
    from t2v.cli.generate import build_parser as j_parser
    from t2v_torch.cli.generate import build_parser, main

    flags = lambda p: {a.option_strings[0]: a.default for a in p._actions if a.option_strings}
    mine, theirs = flags(build_parser()), flags(j_parser())
    assert set(mine) == set(theirs) | {"--device"} and mine["--device"] == "cuda"
    assert {k: v for k, v in mine.items() if k != "--device"} == theirs

    _stable_lora_file(tmp_path / "l.safetensors", tiny_pipe)
    argv = ["--tiny", "--device", "cpu", "--prompt", "a cat", "--steps", "2", "--frames", "3",
            "--width", "32", "--height", "32", "--seed", "5", "--cfg-scale", "9",
            "--outdir", str(tmp_path / "out"), "--lora", str(tmp_path / "l.safetensors"),
            "--profile", str(tmp_path / "trace"), "--json"]
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("merged LoRA l.safetensors")
    out = json.loads(lines[-1])
    assert len(out["videos"]) == 1 and os.path.getsize(out["videos"][0]) > 0
    assert "Seed: 5" in out["infotexts"][0]
    assert len(_pngs(os.path.dirname(out["videos"][0]))) == 3
    assert os.path.exists(tmp_path / "trace" / "trace.json")


def test_output_options_and_metadata_reader(tiny_pipe, tmp_path, warm_pipe_reset):
    """GIF, delete_imgs and path templates through ``run``; the ©cmt
    reader against the JAX package's on a hand-built MP4 and on the cv2
    fallback's file (which carries no metadata)."""
    pytest.importorskip("cv2")
    pytest.importorskip("PIL")
    from PIL import Image

    from t2v.media.video import read_mp4_metadata_comment as j_read
    from t2v_torch.media.video import read_mp4_metadata_comment

    args = T2VArgs(prompt="x", steps=2, frames=3, width=32, height=32, seed=7)
    out = T2VOutputArgs(fps=4, make_gif=True, delete_imgs=True, image_path="f_%03d_50%.png",
                        mp4_path=str(tmp_path / "custom" / "out.mp4"))
    result = warm_pipe_reset.run(args, out, pipe=tiny_pipe, outdir=str(tmp_path))
    assert result.videos == [str(tmp_path / "custom" / "out.mp4")]
    d = result.frame_dirs[0]
    assert [f for f in os.listdir(d) if f.endswith(".png")] == []   # deleted after the stitch
    assert os.path.exists(os.path.join(d, "args.txt"))
    assert getattr(Image.open(tmp_path / "custom" / "out.gif"), "n_frames", 1) == 3
    result = warm_pipe_reset.run(args, out.replace(delete_imgs=False, mp4_path=None,
                                                   skip_video_creation=True),
                                 pipe=tiny_pipe, outdir=str(tmp_path / "b"))
    d = result.frame_dirs[0]
    assert result.videos == [] and os.path.exists(os.path.join(d, "vid.gif"))
    assert sorted(f for f in os.listdir(d) if f.endswith(".png")) == [
        f"f_{i:03d}_50%.png" for i in range(3)]

    def box(kind, payload, full=False):
        body = (b"\0\0\0\0" if full else b"") + payload
        return (8 + len(body)).to_bytes(4, "big") + kind + body

    text = "a cat\nNegative prompt: x\nSteps: 2"
    data = box(b"data", b"\0\0\0\1\0\0\0\0" + text.encode())
    moov = box(b"moov", box(b"udta", box(b"meta", box(b"ilst", box(b"\xa9cmt", data)), True)))
    p = tmp_path / "meta.mp4"
    p.write_bytes(box(b"ftyp", b"isom\0\0\0\0") + box(b"mdat", b"\0" * 64) + moov)
    assert read_mp4_metadata_comment(str(p)) == j_read(str(p)) == text
    assert read_mp4_metadata_comment(str(tmp_path / "custom" / "out.mp4")) is None


def test_refusals_name_what_and_which_slice(tmp_path, tiny_pipe, warm_pipe_reset, monkeypatch):
    """What the port refuses (textual inversion on VideoCrafter, the depth
    adapter on ModelScope, a shard count below 1, a torchrun launch whose
    request leaves its ranks unused), sharded sampling from the
    CLI and ``run`` (without a process group: every sample in one batched
    loop), and VideoCrafter's branches, which answer through ``run``."""
    import cv2

    from _torch_model_dir import VOCAB, small_vc_pipeline
    from t2v_torch.cli.generate import main
    from t2v_torch.core.config import VideoCrafterUNetConfig
    from t2v_torch.io import train_state
    from t2v_torch.pipeline import pipeline
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    cli_cases = [
        (["--model-type", "VideoCrafter", "--embeddings-dir", "e"],
         "--embeddings-dir: textual inversion splices into the ModelScope text encoder"),
        (["--adapter-ckpt", "a"], "--adapter-ckpt: the depth adapter conditions VideoCrafter"),
        (["--adapter-ckpt", "a", "--dp-shards", "2"],
         "^t2v_torch.generate: --adapter-ckpt: the depth adapter conditions VideoCrafter "
         r"\(--model-type VideoCrafter\)$"),
    ]
    for argv, match in cli_cases:
        with pytest.raises(SystemExit, match=match):
            main(["--device", "cpu", *argv])
    # a torchrun launch of two ranks whose request would not use them is
    # refused before any rank joins the group or loads a model
    monkeypatch.setenv("WORLD_SIZE", "2")
    launch_cases = [
        ([], "2 ranks were started, but no shard count is above 1"),
        (["--model-type", "VideoCrafter", "--vc-sample-type", "ddpm", "--dp-shards", "2"],
         "2 ranks were started, but the VideoCrafter DDPM chain runs the serial loop"),
        (["--dp-shards", "2", "--sp-shards", "2"],
         "a dp=2 x sp=2 x tp=1 mesh needs 4 ranks; 2 were started"),
    ]
    for argv, match in launch_cases:
        with pytest.raises(SystemExit, match="^t2v_torch.generate: " + match):
            main(["--device", "cpu", "--tiny", *argv])
    monkeypatch.delenv("WORLD_SIZE")
    request = ["--device", "cpu", "--tiny", "--steps", "1", "--frames", "2", "--width", "32",
               "--height", "32", "--batch-count", "2", "--skip-video-creation"]
    for shards in (["--dp-shards", "2"], ["--tp-shards", "2"], ["--sp-shards", "2"]):
        outdir = tmp_path / "cli" / shards[0]
        assert main([*request, *shards, "--outdir", str(outdir)]) == 0
        written = sorted(os.listdir(outdir))
        assert len(written) == 2 and len(_pngs(outdir / written[1])) == 2, shards
    run = warm_pipe_reset.run
    args = T2VArgs(prompt="x", steps=1, frames=2, width=32, height=32, seed=1)
    out = T2VOutputArgs(skip_video_creation=True)
    kw = dict(outdir=str(tmp_path), save_frames=False)
    for extra in (dict(dp_shards=2), dict(tp_shards=2, sp_shards=2),
                  dict(depth_ckpt="d", sp_shards=2)):
        res = run(args.replace(batch_count=2), out, pipe=tiny_pipe, **kw, **extra)
        assert [t.split("Seed: ")[1][0] for t in res.infotexts] == ["1", "2"], extra
    with pytest.raises(ValueError, match="dp_shards=0: a shard count is at least 1"):
        run(args, out, pipe=tiny_pipe, dp_shards=0, **kw)
    # VideoCrafter loads by name ('<videocrafter>' implies the family) and
    # answers its default branch ...
    vc = small_vc_pipeline()
    train_state.save_weights(
        str(tmp_path / "models" / "VideoCrafter"), unet_params=dict(vc.unet.named_parameters()),
        vae=vc.vae, clip=vc.clip, unet_cfg=vc.cfg, vae_cfg=vc.vae_cfg, clip_cfg=vc.clip_cfg,
        model_family="videocrafter", tokenizer_vocab=str(VOCAB))
    monkeypatch.setenv("T2V_MODELS_ROOT", str(tmp_path / "models"))
    try:
        res = run(args.replace(model="<videocrafter>"), out, device="cpu", **kw)
        loaded = warm_pipe_reset._warm_pipe
        assert isinstance(loaded, VideoCrafterPipeline) and loaded.model_dir is not None
        assert "Model: VideoCrafter" in res.infotexts[0]
    finally:
        pipeline._PIPELINE_CACHE.clear()
    vc = VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu")
    res = run(args, out, pipe=vc, **kw)
    assert "Model: VideoCrafter" in res.infotexts[0]
    # ... and the others: DPM++ 2M, mask inpainting from an image file, and
    # the adapter's own argument check
    res = run(args, out, pipe=vc, vc_sample_type="dpm++ 2m", **kw)
    assert "Model: VideoCrafter" in res.infotexts[0]
    image = str(tmp_path / "i.png")
    cv2.imwrite(image, np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8))
    res = run(args.replace(inpainting_frames=2, inpainting_image=image), out, pipe=vc, **kw)
    assert "Model: VideoCrafter" in res.infotexts[0]
    with pytest.raises(ValueError, match="not a readable image"):
        run(args.replace(inpainting_frames=1, inpainting_image="i.png"), out, pipe=vc, **kw)
    with pytest.raises(ValueError, match="requires adapter_video"):
        run(args, out, pipe=vc, adapter_ckpt="a", **kw)


def test_api_handlers_match_jax(monkeypatch, tmp_path):
    from t2v.api import handlers as jh
    from t2v_torch.api import handlers as th

    monkeypatch.chdir(tmp_path)
    assert th.api_version_payload() == jh.api_version_payload()
    assert th.version_payload() == jh.version_payload()
    assert th.progress_payload().keys() == jh.progress_payload().keys()
    parsed = [{"prompt": "x"}, {"prompt": "x", "model": "<modelscope>"},
              {"prompt": "x", "steps": "7", "cfg_scale": "9.5", "fps": "30", "seed": "-1",
               "enable_emphasis": "false", "do_vid2vid": "1", "add_soundtrack": "File"},
              {"prompt": "x", "steps": 7, "cfg_scale": 9.5, "fps": 30, "n_prompt": None}]
    for q in parsed:
        (a, o), (ja, jo) = th.build_args(q), jh.build_args(q)
        assert dataclasses.asdict(a) == dataclasses.asdict(ja)
        assert dataclasses.asdict(o) == dataclasses.asdict(jo)
    refused = [{}, {"prompt": "x", "steps": "abc"}, {"prompt": "x", "steps": "0"},
               {"prompt": "x", "sampler": "nope"}, {"prompt": "x", "frames": "2", "steps": "1",
                                                   "inpaint_mode": "bogus"},
               {"prompt": "x", "frames": "2", "steps": "1", "keep_in_vram": "Sometimes"}]
    for q in refused:
        mine, theirs = th.run_response(q, {}), jh.run_response(q, {})
        assert (mine.status, mine.payload) == (theirs.status, theirs.payload) and mine.status == 422
    for mod in (th, jh):
        monkeypatch.setattr(mod, "MAX_UPLOAD_BYTES", 16)
    q, up = {"prompt": "x", "do_vid2vid": True}, {"vid2vid_input": b"0" * 17}
    assert th.run_response(q, up).payload == jh.run_response(q, up).payload
    assert th.run_response(q, up).status == 413
    assert th.metadata_response(b"0" * 17).status == jh.metadata_response(b"0" * 17).status == 413
    assert th.metadata_response(None).payload == jh.metadata_response(None).payload


def _post(url):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_stdlib_server_answers_a_request(tiny_pipe, tmp_path, monkeypatch, warm_pipe_reset):
    pytest.importorskip("cv2")
    from t2v_torch.api.stdlib_server import serve

    monkeypatch.chdir(tmp_path)
    srv = serve(port=0, pipe=tiny_pipe, block=False, device="cpu")
    try:
        host, port = srv.server_address
        base = f"http://{host}:{port}"
        with urllib.request.urlopen(f"{base}/t2v/api_version", timeout=60) as r:
            assert json.loads(r.read()) == {"version": "1.0"}
        with urllib.request.urlopen(f"{base}/", timeout=60) as r:
            assert "<html" in r.read().decode().lower()
        status, body = _post(f"{base}/t2v/run?prompt=a+cat&steps=2&frames=2&width=32"
                             "&height=32&seed=3")
        assert status == 200 and body["mp4s"][0].startswith("data:video/mp4;base64,")
        assert _post(f"{base}/t2v/run?steps=2")[0] == 422
        assert _post(f"{base}/t2v/nope")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_fastapi_app_through_the_stub(tiny_pipe, monkeypatch, tmp_path, warm_pipe_reset):
    pytest.importorskip("cv2")
    import _fastapi_stub as stub

    import t2v_torch

    stub.install(monkeypatch)
    monkeypatch.chdir(tmp_path)
    from t2v_torch.api.app import create_app

    app = create_app(pipe=tiny_pipe, device="cpu")
    assert stub.drive(app, "GET", "/t2v/api_version").json() == {"version": "1.0"}
    assert stub.drive(app, "GET", "/t2v/version").json() == {"version": t2v_torch.__version__}
    assert "<html" in stub.drive(app, "GET", "/").content.lower()
    assert stub.drive(app, "POST", "/t2v/interrupt").status_code == 200
    assert stub.drive(app, "POST", "/t2v/skip").status_code == 200
    r = stub.drive(app, "POST", "/t2v/run", prompt="a fish", steps=2, frames=2, width=32,
                   height=32, seed=3, model=None, keep_in_vram="None")
    assert r.status_code == 200, r.json()
    assert r.json()["mp4s"][0].startswith("data:video/mp4;base64,")
    assert warm_pipe_reset._warm_pipe is None
    assert stub.drive(app, "POST", "/t2v/run", prompt="x", steps="NaN").status_code == 422


def test_phase_times_match_jax(monkeypatch):
    """``PhaseTimes`` against the JAX package's on the same phases and the
    same clock readings: a phase entered twice sums, one that raises still
    counts, and the summaries are equal."""
    import time

    from t2v.core.profiling import PhaseTimes as JPhaseTimes
    from t2v_torch.core.profiling import PhaseTimes

    def drive(cls):
        clock = iter([0.0, 0.5, 1.0, 3.25, 4.0, 4.125, 5.0, 5.75])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        pt = cls()
        for name in ("text", "sample", "text"):
            with pt.phase(name):
                pass
        with pytest.raises(KeyError), pt.phase("decode"):
            raise KeyError("decode")
        return pt

    mine, theirs = drive(PhaseTimes), drive(JPhaseTimes)
    assert mine.times == theirs.times == {"text": 0.625, "sample": 2.25, "decode": 0.75}
    assert mine.summary() == theirs.summary() == "text=0.62s sample=2.25s decode=0.75s"
