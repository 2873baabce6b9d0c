"""Job runner of the port: a request in, PNG frames, ``args.txt``, a
manifest and an mp4 (with its data URL) out.

The port's counterpart of the JAX package's ``pipeline/run.py`` (the
reference's ``render.run`` + ``process_modelscope`` orchestration):
  * model hot-switch by directory (``load_pipeline``), the warm pipe reused
    when a request omits the model, and the 3-state keep-in-VRAM option;
  * vid2vid frame extraction -> latent encode -> ``skip_steps =
    floor(steps * (1 - strength))``;
  * img2vid keyframed inpainting mask (strength forced to 1);
  * the per-batch loop with cooperative interrupt / skip through
    ``core.state.JobState`` and the seed + batch policy;
  * PNG frame dump + ``args.txt`` infotext + mp4 stitch with metadata +
    base64 data URLs.

It runs one device's serial loop. Sharded sampling (``dp/tp/sp_shards`` >
1) is refused until the multi-GPU slice; so are VideoCrafter loading by
name, its depth adapter and its mask inpainting, until the VideoCrafter
slice. A ``VideoCrafterPipeline`` the caller passes in answers through its
own ``infer``, with no step callback (interrupt and skip act between its
batches).
"""

from __future__ import annotations

import math
import os
import re
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from t2v_torch.core import rng as rng_lib
from t2v_torch.core.config import T2VArgs, T2VOutputArgs, sanity_check_args
from t2v_torch.core.dtypes import Policy
from t2v_torch.core.state import InterruptedException, JobState, SkippedException
from t2v_torch.core.state import state as default_state
from t2v_torch.media.video import ffmpeg_stitch_video, vid2frames, video_to_data_url
from t2v_torch.pipeline.pipeline import ModelScopePipeline, load_pipeline


@dataclass
class RunResult:
    videos: list[str] = field(default_factory=list)  # mp4 paths
    data_urls: list[str] = field(default_factory=list)
    frame_dirs: list[str] = field(default_factory=list)
    infotexts: list[str] = field(default_factory=list)
    interrupted: bool = False


def _default_outdir() -> str:
    return os.path.join(os.getcwd(), "outputs", "text2video")


# the reference's module-global warm pipe: reused when a request omits the
# model; cleared when keep_in_vram is off
_warm_pipe = None


def _retention(keep_in_vram) -> str:
    """Normalise the reference's 3-state keep-in-VRAM option:
    'All'/True -> "all", 'Main Model Only' -> "model" (retain the UNet,
    drop the VAE and text tower between runs), 'None'/False/None ->
    "none" (nothing retained)."""
    if keep_in_vram in (True, "All", "all"):
        return "all"
    if keep_in_vram in ("Main Model Only", "model", "main model only"):
        return "model"
    if keep_in_vram in (False, None, "None", "none"):
        return "none"
    raise ValueError(f"invalid keep_in_vram value {keep_in_vram!r}")


def _refuse_later_slices(*, adapter_ckpt, adapter_video, depth_ckpt, depth_estimator, dp_shards,
                         tp_shards, sp_shards) -> None:
    """Name what the port does not run yet, and the slice that brings it."""
    shards = {"dp_shards": dp_shards, "tp_shards": tp_shards, "sp_shards": sp_shards}
    asked = [f"{k}={v}" for k, v in shards.items() if v > 1]
    if asked:
        raise NotImplementedError(
            f"run: {', '.join(asked)}: sharded sampling is not ported yet (the multi-GPU "
            "slice); the port samples on one device")
    later = {
        "adapter_ckpt": adapter_ckpt, "adapter_video": adapter_video, "depth_ckpt": depth_ckpt,
        "depth_estimator": depth_estimator,
    }
    asked = [k for k, v in later.items() if v is not None]
    if asked:
        raise NotImplementedError(
            f"run: {', '.join(asked)}: the VideoCrafter depth adapter is not ported yet "
            "(the VideoCrafter slice)")


def _prepare_vid2vid(pipe: ModelScopePipeline, args: T2VArgs):
    """vid2vid inputs: the source's frames from the start frame, resized
    and encoded; the steps the strength skips."""
    import cv2

    frames = vid2frames(
        args.vid2vid_input,
        start_frame=args.vid2vid_startFrame,
        end_frame=args.vid2vid_startFrame + args.frames,
    )
    if len(frames) < args.frames:
        raise ValueError(
            f"source video supplied {len(frames)} frames, need {args.frames}"
        )
    resized = [
        cv2.resize(f, (args.width, args.height), interpolation=cv2.INTER_LANCZOS4)
        for f in frames
    ]
    arr = np.stack(resized).astype(np.float32) / 255.0 * 2.0 - 1.0
    latents = pipe.compute_latents(arr)
    skip_steps = int(
        math.floor(args.steps * max(0.0, min(1.0 - args.strength, 1.0)))
    )
    return latents, skip_steps


def run(
    args: T2VArgs,
    out_args: T2VOutputArgs | None = None,
    *,
    pipe=None,
    outdir: Optional[str] = None,
    job_state: Optional[JobState] = None,
    save_frames: bool = True,
    callback_interval: Optional[int] = 5,
    error_video_on_failure: bool = False,
    adapter_ckpt: Optional[str] = None,
    adapter_video: Optional[str] = None,
    depth_ckpt: Optional[str] = None,
    depth_estimator=None,
    dp_shards: int = 1,
    tp_shards: int = 1,
    sp_shards: int = 1,
    deep_cache_interval: int = 1,
    keep_in_vram: bool | str | None = True,
    inpaint_mode: str = "initial_only",
    vc_sample_type: str = "ddim",
    vc_uc_type: Optional[str] = None,
    device: str = "cuda",
) -> RunResult:
    """Answer ``args.batch_count`` batches and write their outputs under
    ``outdir``. Without ``pipe`` the model directory comes from
    ``args.model`` (``_resolve_model_dir``) through ``load_pipeline`` on
    ``device`` (bf16 on the card, float32 on the CPU); ``args.model=None``
    reuses the warm pipe of the last run.

    error_video_on_failure=True reproduces the reference UI behaviour: any
    generation exception yields the error-placeholder data URL instead of
    propagating. The API layer uses the exception path.

    keep_in_vram is the reference's 3-state option: 'All'/True retains the
    whole pipeline; 'Main Model Only' retains the UNet but drops the VAE
    and text tower after the run (they reload from the model dir on the
    next request); 'None'/False retains nothing."""
    if error_video_on_failure:
        try:
            return run(
                args, out_args, pipe=pipe, outdir=outdir, job_state=job_state,
                save_frames=save_frames, callback_interval=callback_interval,
                error_video_on_failure=False,
                adapter_ckpt=adapter_ckpt, adapter_video=adapter_video,
                depth_ckpt=depth_ckpt, depth_estimator=depth_estimator,
                dp_shards=dp_shards, tp_shards=tp_shards, sp_shards=sp_shards,
                deep_cache_interval=deep_cache_interval,
                keep_in_vram=keep_in_vram, inpaint_mode=inpaint_mode,
                vc_sample_type=vc_sample_type, vc_uc_type=vc_uc_type, device=device,
            )
        except Exception:
            import traceback

            traceback.print_exc()
            from t2v_torch.media.error_video import get_error_video_data_url

            return RunResult(data_urls=[get_error_video_data_url()])

    out_args = out_args or T2VOutputArgs()
    job_state = job_state or default_state
    sanity_check_args(args)
    retention = _retention(keep_in_vram)
    _refuse_later_slices(adapter_ckpt=adapter_ckpt, adapter_video=adapter_video,
                         depth_ckpt=depth_ckpt,
                         depth_estimator=depth_estimator, dp_shards=dp_shards,
                         tp_shards=tp_shards, sp_shards=sp_shards)

    global _warm_pipe
    if pipe is None:
        if args.model is None and _warm_pipe is not None:
            # warm-pipe quirk: an omitted model with a loaded pipe reuses
            # the previous model instead of the default
            pipe = _warm_pipe
        elif args.model_type == "VideoCrafter" or args.model == "<videocrafter>":
            raise NotImplementedError(
                "run: loading VideoCrafter by name (load_vc_pipeline) is not ported yet (the "
                "VideoCrafter slice); pass a VideoCrafterPipeline as pipe=")
        else:
            # drop the warm pipe first, so that a hot switch never holds
            # two models on the card
            _warm_pipe = None
            # bf16 on the card; the CPU runs float32, as the CLIs do
            policy = Policy.fp32() if torch.device(device).type == "cpu" else Policy.bf16()
            pipe = load_pipeline(
                _resolve_model_dir(args.model or "<modelscope>"), policy,
                keep_in_vram=retention != "none", device=device,
            )
    _warm_pipe = pipe if retention != "none" else None
    is_ms = isinstance(pipe, ModelScopePipeline)
    if is_ms:
        # a warm pipe retained under 'Main Model Only' comes back without
        # its VAE and text tower: read them again (a no-op when resident)
        pipe.reload_aux()

    job_state.reset()
    result = RunResult()
    timestring = time.strftime("%Y%m%d%H%M%S")
    outdir = outdir or _default_outdir()

    latents = None
    mask = None
    skip_steps = 0
    is_vid2vid = False
    try:
        if args.do_vid2vid and args.vid2vid_input:
            latents, skip_steps = _prepare_vid2vid(pipe, args)
            is_vid2vid = True
        resolved_seed = rng_lib.resolve_seed(args.seed)

        for batch in range(args.batch_count):
            if job_state.interrupted:
                result.interrupted = True
                break
            job_state.begin_job(batch, args.batch_count, args.steps - skip_steps)

            batch_args = args.replace(seed=resolved_seed)

            image_latents = None
            if args.inpainting_frames > 0 and args.inpainting_image:
                if not is_ms:
                    raise NotImplementedError(
                        "run: VideoCrafter mask inpainting is not ported yet (the "
                        "VideoCrafter slice)")
                import cv2

                img = cv2.cvtColor(cv2.imread(args.inpainting_image), cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (args.width, args.height))
                gen = rng_lib.generator(resolved_seed + batch, pipe.device)
                latents, mask, image_latents = pipe.build_inpainting_inputs(
                    img, batch_args, gen
                )
                batch_args = batch_args.replace(strength=1.0)

            try:
                if is_ms:
                    res = pipe.infer(
                        batch_args,
                        latents=latents,
                        mask=mask,
                        image_latents=image_latents,
                        skip_steps=skip_steps,
                        is_vid2vid=is_vid2vid,
                        batch_index=batch,
                        callback=job_state.step_callback,
                        callback_interval=callback_interval,
                        deep_cache_interval=deep_cache_interval,
                        inpaint_mode=inpaint_mode,
                    )
                else:
                    # VideoCrafter answers its default branch and refuses
                    # the others by name; it takes no step callback yet, so
                    # interrupt and skip act between its batches
                    res = pipe.infer(
                        batch_args,
                        batch_index=batch,
                        sample_type=vc_sample_type,
                        uc_type=vc_uc_type,
                    )
            except SkippedException:
                continue
            except InterruptedException:
                result.interrupted = True
                break

            _emit_batch(
                result, list(res.frames), res.infotext, args, out_args, outdir,
                timestring, batch, resolved_seed + batch, save_frames, pipe.device,
            )

        return result
    finally:
        # 'Main Model Only': retain the warm UNet, drop the VAE and text
        # tower until the next request, also when infer or a save raised
        if retention == "model" and is_ms:
            pipe.release_aux()


def _emit_batch(
    result: RunResult, frames, infotext, args, out_args, outdir, timestring,
    batch: int, seed: int, save_frames: bool, device="cpu",
) -> None:
    """PNG dump + args.txt + manifest + mp4 stitch + data URL for one batch."""
    batch_dir = os.path.join(
        outdir, timestring if batch == 0 else f"{timestring}_{batch}"
    )
    os.makedirs(batch_dir, exist_ok=True)

    def _img_path(i: int) -> str:
        # image_path template (e.g. ".../%09d.png"); relative templates
        # resolve inside the batch dir. Substitute ONLY the first %d spec:
        # templates with stray '%' or extra conversions (e.g.
        # 'f_%03d_%s.png', '50%_%d.png') must not fail at emit time, after
        # the expensive sampling already ran
        tpl = out_args.image_path
        if tpl:
            spec = re.search(r"%0?\d*d", tpl)
            if spec:
                p = tpl[: spec.start()] + (spec.group() % i) + tpl[spec.end():]
            else:
                p = os.path.join(tpl, f"{i:09d}.png")
            return p if os.path.isabs(p) else os.path.join(batch_dir, p)
        return os.path.join(batch_dir, f"{i:09d}.png")

    written_pngs: list[str] = []
    if save_frames:
        import cv2

        for i, frame in enumerate(frames):
            p = _img_path(i)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            cv2.imwrite(p, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            written_pngs.append(p)
        with open(os.path.join(batch_dir, "args.txt"), "w") as f:
            f.write(infotext)
        from t2v_torch.core.profiling import RunManifest

        RunManifest.from_args(args, seed=seed, device=device).write(batch_dir)

    # functional upscale / frame interpolation (the reference carries these
    # fields but never implements them)
    fps = out_args.fps
    if out_args.r_upscale_video or (
        (out_args.frame_interpolation_engine or "None") != "None"
    ):
        from t2v_torch.media.postprocess import postprocess_frames

        frames, fps = postprocess_frames(frames, out_args)
        keep = (
            out_args.r_upscale_video and out_args.r_upscale_keep_imgs
        ) or (
            (out_args.frame_interpolation_engine or "None") != "None"
            and out_args.frame_interpolation_keep_imgs
        )
        if save_frames and keep:
            import cv2

            post_dir = os.path.join(batch_dir, "post")
            os.makedirs(post_dir, exist_ok=True)
            for i, frame in enumerate(frames):
                cv2.imwrite(
                    os.path.join(post_dir, f"{i:09d}.png"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
                )

    if out_args.mp4_path:
        stem, ext = os.path.splitext(out_args.mp4_path)
        mp4_path = out_args.mp4_path if batch == 0 else f"{stem}_{batch}{ext}"
        if not os.path.isabs(mp4_path):
            mp4_path = os.path.join(batch_dir, mp4_path)
    else:
        mp4_path = os.path.join(batch_dir, "vid.mp4")
    if not out_args.skip_video_creation:
        os.makedirs(os.path.dirname(mp4_path), exist_ok=True)
        # "Init Video" soundtrack mode muxes the vid2vid source's audio
        # track; "File" uses soundtrack_path
        audio_path = out_args.soundtrack_path or None
        if out_args.add_soundtrack == "Init Video":
            audio_path = args.vid2vid_input or None
        ffmpeg_stitch_video(
            frames=frames,
            out_path=mp4_path,
            fps=fps,
            crf=out_args.ffmpeg_crf,
            preset=out_args.ffmpeg_preset,
            metadata_comment=infotext,
            add_soundtrack=out_args.add_soundtrack,
            audio_path=audio_path,
            ffmpeg_location=out_args.ffmpeg_location,
        )
        result.videos.append(mp4_path)
        result.data_urls.append(video_to_data_url(mp4_path))
        if out_args.delete_imgs:
            # reference semantics: drop the PNG dump once the mp4 exists;
            # args.txt and the manifest are kept
            for p in written_pngs:
                try:
                    os.remove(p)
                except OSError:
                    pass
    if out_args.make_gif:
        # the GIF consumes only the in-memory frames: written even with
        # skip_video_creation set
        from t2v_torch.media.video import save_gif

        os.makedirs(os.path.dirname(mp4_path), exist_ok=True)
        save_gif(frames, os.path.splitext(mp4_path)[0] + ".gif", fps)
    result.frame_dirs.append(batch_dir)
    result.infotexts.append(infotext)


def _resolve_model_dir(model: str) -> str:
    """Model name -> directory: '<modelscope>' -> models/ModelScope/t2v,
    '<videocrafter>' -> models/VideoCrafter, else models/text2video/<name>,
    under ``$T2V_MODELS_ROOT`` (default ``./models``)."""
    root = os.environ.get("T2V_MODELS_ROOT", os.path.join(os.getcwd(), "models"))
    if model == "<modelscope>":
        return os.path.join(root, "ModelScope", "t2v")
    if model == "<videocrafter>":
        return os.path.join(root, "VideoCrafter")
    return os.path.join(root, "text2video", model)
