"""Generation CLI of the port. Flags mirror the T2VArgs schema plus the
output options, and ``--device`` (the card by default).

Usage:
  python -m t2v_torch.cli.generate --model-dir /path/to/modelscope \\
      --prompt "a bunny in the forest" --frames 24 --steps 30
  python -m t2v_torch.cli.generate --serve --port 7860      # WebAPI server

On the card the weights are bf16 unless ``--fp32``; on the CPU
(``--device cpu``) they are float32 and every kernel runs its plain
PyTorch version. Not ported yet, and refused by name: textual-inversion
embeddings (``--embeddings-dir``), VideoCrafter checkpoints
(``--model-type VideoCrafter --model-dir``), the depth adapter
(``--adapter-*``, ``--depth-ckpt``) and sharded sampling (``--dp/--tp/
--sp-shards`` above 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from t2v_torch.core.config import SAMPLER_NAMES

    p = argparse.ArgumentParser("t2v_torch.generate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", help="ModelScope-layout model directory, or one the trainer saved")
    p.add_argument("--model", default="<modelscope>", help="model name (<modelscope>, or a "
                   "directory under $T2V_MODELS_ROOT/text2video)")
    p.add_argument("--model-type", default="ModelScope", choices=["ModelScope", "VideoCrafter"])
    p.add_argument("--prompt", default="")
    p.add_argument("--n-prompt", default="text, watermark, copyright, blurry, nsfw")
    p.add_argument("--sampler", default="DDIM_Gaussian", choices=list(SAMPLER_NAMES))
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--cfg-scale", type=float, default=17.0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--batch-count", type=int, default=1)
    # vid2vid
    p.add_argument("--vid2vid-input", help="source video for vid2vid")
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--vid2vid-start-frame", type=int, default=0)
    # img2vid inpainting
    p.add_argument("--inpainting-image")
    p.add_argument("--inpainting-frames", type=int, default=0)
    p.add_argument("--inpainting-weights", default='0:(t/max_i_f), "max_i_f":(1)')
    p.add_argument("--cond-fps", type=int,
                   help="frame rate to condition on (FPS-conditioned VideoCrafter models)")
    p.add_argument(
        "--inpaint-mode", default="initial_only", choices=["initial_only", "progressive"],
        help="initial_only = reference parity (mask applied once to the start latents); "
        "progressive = per-step hardening re-blend",
    )
    # lora
    p.add_argument("--lora", action="append", default=[],
                   help=".safetensors stable-lora file (repeatable)")
    p.add_argument("--lora-alpha", type=float, default=1.0)
    p.add_argument("--vc-sample-type", default="ddim", choices=["ddim", "ddpm", "dpm++ 2m"],
                   help="VideoCrafter denoising chain (only ddim is ported)")
    p.add_argument("--uc-type", default=None, choices=["cfg_original", "cfg_ours"],
                   help="VideoCrafter CFG variant (not ported yet)")
    p.add_argument("--adapter-ckpt", help="T2I-Adapter checkpoint (not ported yet)")
    p.add_argument("--adapter-video", help="adapter input video (not ported yet)")
    p.add_argument("--depth-ckpt", help="midas_v21_small checkpoint (not ported yet)")
    p.add_argument("--embeddings-dir",
                   help="textual-inversion embeddings directory (not ported yet)")
    p.add_argument(
        "--comma-padding-backtrack", type=int, default=20,
        help="A1111 opts.comma_padding_backtrack: move the tail after a comma to the next "
        "75-token chunk when within N tokens (0 = off)",
    )
    p.add_argument("--no-emphasis", action="store_true",
                   help="disable (word:1.2) emphasis parsing (A1111 opts.enable_emphasis)")
    p.add_argument(
        "--deep-cache", type=int, default=1, metavar="K",
        help="DeepCache acceleration: full UNet every K steps, cached deep trunk in between "
        "(txt2vid, DDIM samplers; 1 = exact/off)",
    )
    # output
    p.add_argument("--outdir")
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--crf", type=int, default=17)
    p.add_argument("--preset", default="slow")
    p.add_argument("--add-soundtrack", default="None", choices=["None", "File", "Init Video"])
    p.add_argument("--soundtrack-path", default="")
    p.add_argument("--skip-video-creation", action="store_true")
    p.add_argument("--upscale", action="store_true", help="upscale output frames (r_upscale_video)")
    p.add_argument("--upscale-factor", default="x2", choices=["x2", "x3", "x4"])
    p.add_argument("--upscale-model", default="realesr-animevideov3",
                   help="resampling flavor; 'bicubic' or Lanczos otherwise")
    p.add_argument("--interpolate", type=int, default=0, metavar="X",
                   help="optical-flow frame interpolation x-amount (0/1 = off)")
    p.add_argument("--slow-mo", type=int, default=0, metavar="AMT",
                   help="with --interpolate: slow motion by AMT instead of raising fps")
    # runtime
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--fp32", action="store_true",
                   help="float32 weights on the card (default bf16; the CPU always runs float32)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model (smoke test, no checkpoints)")
    p.add_argument("--dp-shards", type=int, default=1, help="data-parallel sampling (not ported yet)")
    p.add_argument("--tp-shards", type=int, default=1, help="tensor-parallel UNet (not ported yet)")
    p.add_argument("--sp-shards", type=int, default=1, help="frame-axis sharding (not ported yet)")
    p.add_argument("--profile", help="write a torch.profiler trace (trace.json) to this dir")
    # server mode
    p.add_argument("--serve", action="store_true", help="run the WebAPI instead")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--json", action="store_true", help="print result as JSON")
    p.add_argument(
        "--no-keep-in-vram", action="store_true",
        help="drop the pipeline cache after each run (reference keep-in-VRAM 'None' "
        "setting), mainly for the --serve mode",
    )
    p.add_argument(
        "--keep-in-vram", default=None, choices=["All", "Main Model Only", "None"],
        help="reference 3-state retention option: 'Main Model Only' keeps the UNet warm but "
        "reloads VAE/CLIP per run; overrides --no-keep-in-vram",
    )
    return p


def _refusals(ns) -> list[str]:
    """The flags of ``ns`` that ask for what the port does not run yet,
    each with the slice that brings it."""
    out = []
    if ns.embeddings_dir:
        out.append("--embeddings-dir: textual inversion is not ported yet (the ModelScope "
                   "LoRA and text slice)")
    if ns.model_dir and ns.model_type == "VideoCrafter":
        out.append("--model-type VideoCrafter --model-dir: the VideoCrafter loaders are not "
                   "ported yet (the VideoCrafter slice)")
    for flag in ("adapter_ckpt", "adapter_video", "depth_ckpt"):
        if getattr(ns, flag):
            out.append(f"--{flag.replace('_', '-')}: the depth adapter is not ported yet (the "
                       "VideoCrafter slice)")
    for flag in ("dp_shards", "tp_shards", "sp_shards"):
        if getattr(ns, flag) > 1:
            out.append(f"--{flag.replace('_', '-')} {getattr(ns, flag)}: sharded sampling is "
                       "not ported yet (the multi-GPU slice)")
    return out


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    refused = _refusals(ns)
    if refused:
        raise SystemExit("t2v_torch.generate: " + "; ".join(refused))

    from t2v_torch.pipeline.pipeline import ModelScopePipeline, resolve_device

    device = resolve_device(ns.device)
    if ns.serve:
        try:
            import uvicorn

            from t2v_torch.api.app import create_app

            uvicorn.run(create_app(device=str(device)), host=ns.host, port=ns.port)
        except ImportError:
            from t2v_torch.api.stdlib_server import serve

            serve(host=ns.host, port=ns.port, device=str(device))
        return 0

    from t2v_torch.core.config import T2VArgs, T2VOutputArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.core.profiling import trace
    from t2v_torch.pipeline.run import run

    args = T2VArgs(
        prompt=ns.prompt,
        n_prompt=ns.n_prompt,
        sampler=ns.sampler,
        steps=ns.steps,
        frames=ns.frames,
        seed=ns.seed,
        cfg_scale=ns.cfg_scale,
        width=ns.width,
        height=ns.height,
        eta=ns.eta,
        batch_count=ns.batch_count,
        do_vid2vid=bool(ns.vid2vid_input),
        vid2vid_input=ns.vid2vid_input,
        strength=ns.strength,
        vid2vid_startFrame=ns.vid2vid_start_frame,
        inpainting_image=ns.inpainting_image,
        inpainting_frames=ns.inpainting_frames,
        inpainting_weights=ns.inpainting_weights,
        cond_fps=ns.cond_fps,
        comma_padding_backtrack=ns.comma_padding_backtrack,
        enable_emphasis=not ns.no_emphasis,
        model_type=ns.model_type,
        model=ns.model,
    )
    out_args = T2VOutputArgs(
        skip_video_creation=ns.skip_video_creation,
        fps=ns.fps,
        ffmpeg_crf=ns.crf,
        ffmpeg_preset=ns.preset,
        add_soundtrack=ns.add_soundtrack,
        soundtrack_path=ns.soundtrack_path,
        r_upscale_video=ns.upscale,
        r_upscale_factor=ns.upscale_factor,
        r_upscale_model=ns.upscale_model,
        frame_interpolation_engine=("FILM" if ns.interpolate > 1 else "None"),
        frame_interpolation_x_amount=max(ns.interpolate, 1),
        frame_interpolation_slow_mo_enabled=ns.slow_mo > 0,
        frame_interpolation_slow_mo_amount=max(ns.slow_mo, 1),
    )

    policy = Policy.fp32() if ns.fp32 or device.type == "cpu" else Policy.bf16()
    pipe = None
    if ns.tiny:
        if ns.model_type == "VideoCrafter":
            from t2v_torch.core.config import VideoCrafterUNetConfig
            from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

            pipe = VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), policy,
                                                    device=device)
        else:
            pipe = ModelScopePipeline.random_init(policy=policy, device=device)
    elif ns.model_dir:
        pipe = ModelScopePipeline.from_model_dir(ns.model_dir, policy, device=device)
    if ns.lora:
        if not isinstance(pipe, ModelScopePipeline):
            raise SystemExit("--lora: stable-lora files merge into a ModelScope pipeline "
                             "(--tiny or --model-dir); VideoCrafter LoRA is not ported yet")
        from t2v_torch.io.safetensors_io import load_safetensors

        for lora_path in ns.lora:
            lora_sd, _ = load_safetensors(lora_path)
            # merges UNet AND the CLIP text tower, as the reference does
            skipped = pipe.apply_stable_lora(lora_sd, ns.lora_alpha)
            n_skip = len(set(skipped["unet"]) & set(skipped["clip"]))
            print(f"merged LoRA {os.path.basename(lora_path)} (skipped {n_skip} modules)")

    with trace(ns.profile):
        result = run(
            args, out_args, pipe=pipe, outdir=ns.outdir,
            deep_cache_interval=ns.deep_cache,
            keep_in_vram=(
                ns.keep_in_vram if ns.keep_in_vram is not None else not ns.no_keep_in_vram
            ),
            inpaint_mode=ns.inpaint_mode,
            vc_sample_type=ns.vc_sample_type, vc_uc_type=ns.uc_type, device=str(device),
        )

    if ns.json:
        print(json.dumps({"videos": result.videos, "infotexts": result.infotexts}))
    else:
        for v in result.videos:
            print(v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
