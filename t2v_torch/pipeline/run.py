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

A request runs one device's serial loop, or with ``dp/tp/sp_shards`` above
1 the sharded sampler (``_run_dp``). A VideoCrafter model loads by name
(``load_vc_pipeline``; ``'<videocrafter>'`` implies the family) and answers
through its own ``infer``: ``vc_sample_type`` (DDIM, DPM++ 2M or the DDPM
chain, which takes no step callback), ``vc_uc_type``, LVDM mask inpainting
from ``args.inpainting_image``, and the depth adapter (``adapter_ckpt`` with
``adapter_video``: an RGB video whose depth MiDaS estimates when
``depth_ckpt`` or a ``depth_estimator`` is given, else precomputed depth
maps).

Sharded sampling (``parallel/dp_sample.py``): with a process group of at
least dp·tp·sp ranks (``parallel/multihost.initialize``, or torchrun), the
batch_count samples split over dp, the frames over sp and the UNet's heads
over tp, from rank 0's seed; rank 0 decodes and writes every batch. Without
a group, the request runs as one batched loop on this process's device.
VideoCrafter's DDPM chain keeps the serial loop. A group of several ranks
that the request would not use (no shard count above 1, the DDPM chain, a
mesh larger than the group) is refused (``group_refusal``): every rank
would answer the whole request.
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
from t2v_torch.core.profiling import PhaseTimes, RunManifest, span
from t2v_torch.core.state import InterruptedException, JobState, SkippedException
from t2v_torch.core.state import state as default_state
from t2v_torch.media.video import ffmpeg_stitch_video, vid2frames, video_to_data_url
from t2v_torch.parallel import multihost
from t2v_torch.parallel.dp_sample import dp_sample, frames_split, sample_generators
from t2v_torch.parallel.mesh import get_mesh
from t2v_torch.parallel.sharding import parallel_unet
from t2v_torch.pipeline.pipeline import ModelScopePipeline, _spatial_scale, _sync, load_pipeline
from t2v_torch.pipeline.videocrafter import load_vc_pipeline


@dataclass
class RunResult:
    videos: list[str] = field(default_factory=list)  # mp4 paths
    data_urls: list[str] = field(default_factory=list)
    frame_dirs: list[str] = field(default_factory=list)
    infotexts: list[str] = field(default_factory=list)
    interrupted: bool = False
    # host seconds of the request's phases, summed over its batches: text,
    # sample, decode (``InferResult.timings``) and emit (``_emit_batch``)
    timings: dict[str, float] = field(default_factory=dict)


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


def group_refusal(world: int, shards: tuple[int, int, int], is_vc: bool,
                  vc_sample_type: str = "ddim") -> str | None:
    """Why a request with (dp, sp, tp) = ``shards`` cannot use a process
    group of ``world`` ranks, or None when it can (or there is no group)."""
    if world <= 1:
        return None
    dp, sp, tp = shards
    if max(shards) == 1:
        return (f"{world} ranks were started, but no shard count is above 1: every rank would "
                "answer the whole request; start one process, or split it with "
                "dp/tp/sp_shards")
    if is_vc and vc_sample_type == "ddpm":
        return (f"{world} ranks were started, but the VideoCrafter DDPM chain runs the serial "
                "loop on one device: start one process, or sample with 'ddim' or 'dpm++ 2m'")
    if world < dp * sp * tp:
        return (f"a dp={dp} x sp={sp} x tp={tp} mesh needs {dp * sp * tp} ranks; {world} were "
                "started")
    return None


def _adapter_features(pipe, args: T2VArgs, adapter_ckpt: str, adapter_video: str | None,
                      depth_ckpt: str | None, depth_estimator):
    """The depth adapter's features for a VideoCrafter request: the first
    ``args.frames`` frames of ``adapter_video``, either RGB whose depth the
    MiDaS stage estimates (``depth_ckpt`` or ``depth_estimator``), or
    precomputed depth maps (the first channel, resized and normalised per
    frame to [-1, 1])."""
    import cv2

    if not adapter_video:
        raise ValueError("adapter_ckpt requires adapter_video (an RGB video when depth_ckpt is "
                         "set, else precomputed depth maps)")
    adapter = pipe.load_adapter(adapter_ckpt)
    frames = vid2frames(adapter_video, start_frame=0, end_frame=args.frames)
    if len(frames) < args.frames:
        raise ValueError(f"{adapter_video}: the adapter video supplied {len(frames)} frames, "
                         f"need {args.frames}")
    if depth_ckpt or depth_estimator is not None:
        from t2v_torch.models.depth import DepthStage

        stage = (DepthStage(depth_estimator, pipe.device) if depth_estimator is not None
                 else DepthStage.from_checkpoint(depth_ckpt, pipe.policy, device=pipe.device))
        d = stage.video_depth(np.stack(frames), (args.height, args.width))
    else:
        d = np.stack([cv2.resize(f, (args.width, args.height)) for f in frames]).astype(
            np.float32)[..., :1]
        dmin = d.min(axis=(1, 2, 3), keepdims=True)
        dmax = d.max(axis=(1, 2, 3), keepdims=True)
        d = 2.0 * (d - dmin) / (dmax - dmin + 1e-7) - 1.0
    return pipe.adapter_features(adapter, torch.as_tensor(d)[None])


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
    ``args.model`` (``_resolve_model_dir``) through ``load_pipeline``, or
    ``load_vc_pipeline`` for a VideoCrafter request, on ``device`` (bf16 on
    the card, float32 on the CPU); ``args.model=None`` reuses the warm pipe
    of the last run.

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
    for name, v in (("dp_shards", dp_shards), ("tp_shards", tp_shards), ("sp_shards", sp_shards)):
        if v < 1:
            raise ValueError(f"{name}={v}: a shard count is at least 1")

    global _warm_pipe
    if pipe is None:
        if args.model is None and _warm_pipe is not None:
            # warm-pipe quirk: an omitted model with a loaded pipe reuses
            # the previous model instead of the default
            pipe = _warm_pipe
        else:
            # drop the warm pipe first, so that a hot switch never holds
            # two models on the card
            _warm_pipe = None
            # bf16 on the card; the CPU runs float32, as the CLIs do
            policy = Policy.fp32() if torch.device(device).type == "cpu" else Policy.bf16()
            keep = retention != "none"
            # '<videocrafter>' implies the family even when model_type was
            # not set (the UI and the API may pass only the model name)
            if args.model_type == "VideoCrafter" or args.model == "<videocrafter>":
                model = args.model or "<videocrafter>"
                model_dir = _resolve_model_dir(
                    "<videocrafter>" if model == "<modelscope>" else model)
                pipe = load_vc_pipeline(model_dir, policy, keep_in_vram=keep, device=device)
            else:
                pipe = load_pipeline(_resolve_model_dir(args.model or "<modelscope>"), policy,
                                     keep_in_vram=keep, device=device)
    _warm_pipe = pipe if retention != "none" else None
    is_ms = isinstance(pipe, ModelScopePipeline)
    refusal = group_refusal(multihost.process_count(), (dp_shards, sp_shards, tp_shards),
                            not is_ms, vc_sample_type)
    if refusal:
        raise ValueError(refusal)
    # a warm pipe retained under 'Main Model Only' comes back without its
    # VAE and text tower: read them again (a no-op when resident)
    pipe.reload_aux()

    job_state.reset()
    result = RunResult()
    timestring = time.strftime("%Y%m%d%H%M%S")
    outdir = outdir or _default_outdir()

    latents = None
    mask = None
    skip_steps = 0
    is_vid2vid = False
    features_adapter = None
    try:
        if args.do_vid2vid and args.vid2vid_input:
            latents, skip_steps = _prepare_vid2vid(pipe, args)
            is_vid2vid = True
        if adapter_ckpt and not is_ms:
            features_adapter = _adapter_features(pipe, args, adapter_ckpt, adapter_video,
                                                 depth_ckpt, depth_estimator)
        resolved_seed = rng_lib.resolve_seed(args.seed)
        # the VideoCrafter DDPM chain (all the schedule's timesteps, not a
        # registry sampler) keeps the serial loop
        if max(dp_shards, tp_shards, sp_shards) > 1 and (is_ms or vc_sample_type != "ddpm"):
            with span("t2v.request", str(resolved_seed)):
                return _run_dp(
                    pipe, args, out_args, outdir, resolved_seed, timestring, save_frames,
                    (dp_shards, sp_shards, tp_shards), features_adapter, job_state,
                    latents=latents, is_vid2vid=is_vid2vid, skip_steps=skip_steps,
                    inpaint_mode=inpaint_mode, vc_sample_type=vc_sample_type,
                    vc_uc_type=vc_uc_type)

        pt = PhaseTimes()
        for batch in range(args.batch_count):
            if job_state.interrupted:
                result.interrupted = True
                break
            job_state.begin_job(batch, args.batch_count, args.steps - skip_steps)

            batch_args = args.replace(seed=resolved_seed)

            image_latents = None
            vc_mask = vc_source = None
            if args.inpainting_frames > 0 and args.inpainting_image:
                import cv2

                img = cv2.imread(args.inpainting_image)
                if img is None:
                    raise ValueError(f"{args.inpainting_image}: not a readable image")
                img = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (args.width, args.height))
                if is_ms:
                    gen = rng_lib.generator(resolved_seed + batch, pipe.device)
                    latents, mask, image_latents = pipe.build_inpainting_inputs(
                        img, batch_args, gen
                    )
                    batch_args = batch_args.replace(strength=1.0)
                else:
                    # LVDM's static mask blend: mask 1 keeps the source
                    vc_mask, vc_source = pipe.build_inpainting_inputs(img, batch_args)

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
                    # the DDPM chain takes no step callback: interrupt and
                    # skip act between its batches
                    ddpm = vc_sample_type == "ddpm"
                    res = pipe.infer(
                        batch_args,
                        batch_index=batch,
                        callback=None if ddpm else job_state.step_callback,
                        callback_interval=None if ddpm else callback_interval,
                        features_adapter=features_adapter,
                        sample_type=vc_sample_type,
                        mask=vc_mask,
                        source_latents=vc_source,
                        uc_type=vc_uc_type,
                    )
            except SkippedException:
                continue
            except InterruptedException:
                result.interrupted = True
                break

            pt.add(res.timings)
            with pt.phase("emit"):
                _emit_batch(
                    result, list(res.frames), res.infotext, args, out_args, outdir,
                    timestring, batch, resolved_seed + batch, save_frames, pipe.device,
                    phase_times=res.timings,
                )

        result.timings = dict(pt.times)
        return result
    finally:
        # 'Main Model Only': retain the warm UNet, drop the VAE and text
        # tower until the next request (of either family), also when infer
        # or a save raised
        if retention == "model":
            pipe.release_aux()


def _run_dp(pipe, args: T2VArgs, out_args, outdir, resolved_seed: int, timestring: str,
            save_frames: bool, shards: tuple[int, int, int], features_adapter,
            job_state: JobState, *, latents=None, is_vid2vid=False, skip_steps=0,
            inpaint_mode="initial_only", vc_sample_type="ddim", vc_uc_type=None) -> RunResult:
    """Every batch of the request in one sharded sampling
    (``parallel/dp_sample.py``) over a (dp, sp, tp) = ``shards`` mesh of the
    default process group, or in one batched loop without a group of that
    many ranks. The sampling takes no step callback: progress is reported
    at its end, and interrupt and skip act between the per-sample decodes.
    Every rank samples from rank 0's seed; rank 0 decodes and writes every
    batch; the other ranks return an empty result.

    ModelScope's masked inpainting start is built per sample with seed + i,
    as the serial loop builds batch i's; LVDM's static mask and the vid2vid
    source broadcast over the samples.

    The result's ``timings`` hold the request's phases: text, sample (one
    synchronize at its end), and decode and emit summed over the batches;
    each batch's manifest records text, sample and its own decode."""
    n = args.batch_count
    steps = args.steps - skip_steps
    job_state.begin_job(0, n, steps)
    dp, sp, tp = shards
    mesh = None
    if multihost.process_count() > 1:  # group_refusal saw a group of dp·sp·tp ranks or more
        mesh = get_mesh(dp, sp, tp)
        # a seed of -1 was drawn on each rank: the samples follow rank 0's
        resolved_seed = multihost.shared_seed(resolved_seed)
        if not mesh.in_mesh:
            return RunResult()

    is_ms = isinstance(pipe, ModelScopePipeline)
    ss = _spatial_scale(pipe.vae_cfg)
    lat_c = 4 if is_ms else pipe.cfg.in_channels
    sample_shape = (args.frames, args.height // ss, args.width // ss, lat_c)
    args_seeded = args.replace(seed=resolved_seed)

    mask = image_latents = None
    strength = float(args.strength)
    if args.inpainting_frames > 0 and args.inpainting_image:
        import cv2

        img = cv2.imread(args.inpainting_image)
        if img is None:
            raise ValueError(f"{args.inpainting_image}: not a readable image")
        img = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (args.width, args.height))
        if is_ms:
            rows = []
            for gen in sample_generators(resolved_seed, n, pipe.device):
                masked_i, mask, image_latents = pipe.build_inpainting_inputs(img, args_seeded, gen)
                rows.append(masked_i)
            latents, strength, is_vid2vid = torch.cat(rows), 1.0, False
        else:
            mask, image_latents = pipe.build_inpainting_inputs(img, args_seeded)
            inpaint_mode = "lvdm_static"

    sp_axis = mesh.sp if mesh is not None and frames_split(args.frames, sp) else None
    pt = PhaseTimes()
    with pt.phase("text"):
        if is_ms:
            pipe.text_encoder.comma_backtrack = args.comma_padding_backtrack
            pipe.text_encoder.enable_emphasis = args.enable_emphasis
            conditioning = pipe.text_encoder.encode_request(args.prompt, args.n_prompt, steps)
            cond, uncond = conditioning.cond, conditioning.uncond
            sampler, combine, param = args.sampler, None, pipe.unet_cfg.parameterization
            apply_fn = lambda x, t, ctx: pipe.unet(x, t, ctx)
        else:
            if vc_sample_type == "dpm++ 2m" and (mask is not None or vc_uc_type):
                raise ValueError("sample_type='dpm++ 2m' does not support mask inpainting or "
                                 "uc_type CFG variants — use 'ddim'")
            cond, uncond = pipe.encode_text([args.prompt]), pipe.encode_text([args.n_prompt])
            sampler = {"ddim": "DDIM", "dpm++ 2m": "DPM++ 2M"}[vc_sample_type]
            combine, param = vc_uc_type, pipe.cfg.parameterization
            feats = features_adapter
            if feats is not None and sp_axis is not None:
                # (B, T, h, w, c) maps follow the frames; (B, h, w, c) ones are per sample
                feats = tuple(sp_axis.shard(f, 1) if f.dim() == 5 else f for f in feats)
            apply_fn = pipe.make_apply_fn(feats, pipe._resolve_temporal_context(args))

    with pt.phase("sample"):
        with parallel_unet(pipe.unet, tp=mesh.tp if mesh is not None else None, sp=sp_axis):
            x0 = dp_sample(
                apply_fn, pipe.schedule, steps=steps, sample_shape=sample_shape, n_samples=n,
                cond=cond, uncond=uncond, guidance_scale=args.cfg_scale, eta=args.eta,
                sampler_name=sampler, seed=resolved_seed, mesh=mesh, parameterization=param,
                latents=latents, is_vid2vid=is_vid2vid, strength=strength, mask=mask,
                image_latents=image_latents, inpaint_mode=inpaint_mode, cfg_combine_mode=combine)
        _sync(pipe.device)
    job_state.sampling_step = steps

    result = RunResult()
    if not multihost.is_primary():
        result.timings = dict(pt.times)
        return result
    for batch in range(n):
        if job_state.interrupted:
            result.interrupted = True
            break
        if job_state.skipped:
            job_state.skipped = False
            continue
        decoded = pt.times.get("decode", 0.0)
        with pt.phase("decode"):
            frames = pipe.decode_latents(x0[batch])
        phases = {"text": pt.times["text"], "sample": pt.times["sample"],
                  "decode": pt.times["decode"] - decoded}
        with pt.phase("emit"):
            _emit_batch(
                result, list(frames), pipe.create_infotext(args, resolved_seed + batch), args,
                out_args, outdir, timestring, batch, resolved_seed + batch, save_frames,
                pipe.device, phase_times=phases)
    result.timings = dict(pt.times)
    return result


def _emit_batch(
    result: RunResult, frames, infotext, args, out_args, outdir, timestring,
    batch: int, seed: int, save_frames: bool, device="cpu", phase_times=None,
) -> None:
    """PNG dump + args.txt + manifest + mp4 stitch + data URL for one batch;
    the manifest records ``phase_times``, the batch's request phases."""
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
        RunManifest.from_args(args, seed=seed, device=device,
                              phase_times=phase_times).write(batch_dir)

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
