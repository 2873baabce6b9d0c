"""Fine-tuning CLI of the port: WebVid data -> diffusion training on one GPU
or over a dp x sp x tp mesh of ranks.

Clips are VAE-encoded on the device, captions text-encoded, and the train
step (``t2v_torch/parallel/train.py``) runs for either UNet family, as a
LoRA over the ModelScope UNet's linears or as a full fine-tune with an
optional EMA shadow. LoRA runs save reference-compatible stable-lora
``.safetensors``; full runs save the weights as safetensors (with the BPE
vocab, so that the directory loads with ``--model-dir``); both save the
full train state for ``--resume``. ``--model-dir`` fine-tunes a model
directory (the published layout or a saved one) of the ``--model-type``
family in the device's dtype; ``--vc-ckpt`` a VideoCrafter ``model.ckpt``.

Usage:
  python -m t2v_torch.cli.train --data-dir /data/webvid --tiny \\
      --batch-size 2 --steps 100 --save-every 50 --out ckpts/

Over several ranks, under torchrun (one process a rank; ranks that share a
card talk over gloo, else NCCL):
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m t2v_torch.cli.train --data-dir /data/webvid --sp 2 --tp 1 ...

splits the frames over ``--sp`` ranks, the attention heads and GEGLU widths
over ``--tp``, and the batch over the ranks left over (dp = ranks // (sp x
tp)), as the JAX CLI's ``MeshConfig(dp=-1)``: the same steps as one
process on the global batch. Every rank reads the same clips from rank 0's
seed and encodes only its samples and frames; rank 0 alone gathers and
writes the weights and the train state, which ``--resume`` restores on
every rank and cuts to its pieces.

On the card the models run in bfloat16 (the kernels take nothing else); with
``--device cpu`` they run in float32 through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("t2v_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--meta-path")
    p.add_argument("--model-dir", help="model directory of the --model-type family to fine-tune "
                   "(the published layout, or one this trainer saved); default: seeded random "
                   "weights")
    p.add_argument("--model-type", default="ModelScope", choices=["ModelScope", "VideoCrafter"],
                   help="UNet family to train (both share the step)")
    p.add_argument("--vc-ckpt", help="VideoCrafter model.ckpt to fine-tune from")
    p.add_argument("--out", default="ckpts")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--frame-stride", type=int, default=1)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel shards: ranks that split a clip's frames")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards: ranks that split the attention heads and "
                   "GEGLU widths")
    p.add_argument("--tiny", action="store_true", help="tiny random model (smoke test)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="train a rank-r LoRA over attention/ff linears instead of full params; "
                   "saves reference-compatible stable-lora .safetensors")
    p.add_argument("--lora-alpha", type=float, default=1.0)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA shadow decay (e.g. 0.9999); 0 disables (full fine-tune only)")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="resume from a saved train state: a step_N dir, or bare --resume to "
                   "pick the newest one under --out (params, optimizer, EMA, step counter)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing: rematerialise the UNet forward in the "
                   "backward pass (fits longer clips / larger batches)")
    return p


def _mesh_refusal(ns, world: int | None) -> str | None:
    """Why a mesh of ``--sp`` x ``--tp`` over ``world`` ranks (None: no
    process group) cannot train this run, or None."""
    if ns.sp < 1 or ns.tp < 1:
        return f"--sp/--tp: shard counts are at least 1 (got --sp {ns.sp} --tp {ns.tp})"
    if ns.frames % ns.sp:
        return f"--sp {ns.sp}: the {ns.frames} frames of a clip (--frames) do not divide by it"
    if world is None:
        if ns.sp > 1 or ns.tp > 1:
            return (f"--sp {ns.sp} --tp {ns.tp}: training over a mesh needs a process group; "
                    "launch one rank a process with python -m torch.distributed.run "
                    "--nproc-per-node N -m t2v_torch.cli.train ...")
        return None
    if world % (ns.sp * ns.tp):
        return f"--sp {ns.sp} --tp {ns.tp}: {world} ranks do not divide by sp x tp"
    dp = world // (ns.sp * ns.tp)
    if ns.batch_size % dp:
        return f"--batch-size {ns.batch_size} does not divide by dp = {dp} (ranks // (sp x tp))"
    return None


def _launched_with_group() -> bool:
    """True under torchrun (more than one rank in the environment) or
    inside a process group already joined."""
    import torch.distributed as dist

    return dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.vc_ckpt and (ns.model_type != "VideoCrafter" or ns.model_dir):
        raise SystemExit("--vc-ckpt: a VideoCrafter checkpoint, taken with --model-type "
                         "VideoCrafter and without --model-dir")
    grouped = _launched_with_group()
    refusal = None if grouped else _mesh_refusal(ns, None)
    if refusal:
        raise SystemExit(refusal)

    from t2v_torch.parallel import multihost
    from t2v_torch.parallel.mesh import get_mesh

    mesh, own_group = None, False
    if grouped:
        import torch.distributed as dist

        own_group = not dist.is_initialized()
        if own_group:
            multihost.initialize(device=ns.device)
    try:
        if grouped:
            world = multihost.process_count()
            refusal = _mesh_refusal(ns, world)
            if refusal:
                raise SystemExit(refusal)
            mesh = get_mesh(world // (ns.sp * ns.tp), ns.sp, ns.tp)
            ns.seed = multihost.shared_seed(ns.seed)
        return _train(ns, mesh)
    finally:
        if own_group:
            multihost.shutdown()


def _train(ns, mesh) -> int:
    """The run of ``main`` on this rank of ``mesh`` (None: one process)."""
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, VideoCrafterUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.data.webvid import WebVidDataset
    from t2v_torch.io.train_state import (
        full_tensors,
        latest_train_state,
        restore_train_state,
        save_train_state,
        save_weights,
        train_state_mode,
    )
    from t2v_torch.parallel import multihost
    from t2v_torch.parallel.sharding import tp_layout
    from t2v_torch.parallel.train import (
        init_train_state,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
        module_apply_fn,
    )
    from t2v_torch.pipeline.pipeline import ModelScopePipeline, resolve_device

    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    device = multihost.rank_device(ns.device) if mesh is not None else resolve_device(ns.device)
    policy = Policy.bf16() if device.type == "cuda" else Policy.fp32()
    is_vc = ns.model_type == "VideoCrafter"
    if is_vc:
        from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

        if ns.vc_ckpt:
            pipe = VideoCrafterPipeline.from_checkpoint(ns.vc_ckpt, policy=policy, device=device)
        elif ns.model_dir:
            pipe = VideoCrafterPipeline.from_model_dir(ns.model_dir, policy, device=device)
        else:
            cfg = VideoCrafterUNetConfig().tiny() if ns.tiny else VideoCrafterUNetConfig()
            pipe = VideoCrafterPipeline.random_init(cfg, policy, seed=ns.seed, device=device)
        unet_cfg, text_model = pipe.cfg, pipe.clip
        vocab = getattr(pipe.tokenizer, "source_path", None)
        encode_caption = lambda c: pipe.encode_text([c])
    else:
        if ns.model_dir:
            pipe = ModelScopePipeline.from_model_dir(ns.model_dir, policy, device=device)
        else:
            cfg = ModelScopeUNetConfig().tiny() if ns.tiny else ModelScopeUNetConfig()
            pipe = ModelScopePipeline.random_init(cfg, policy, seed=ns.seed, device=device)
        unet_cfg, text_model = pipe.unet_cfg, pipe.text_encoder.model
        vocab = getattr(pipe.text_encoder.tokenizer, "source_path", None)
        encode_caption = lambda c: pipe.text_encoder.encode_line(c)[None]

    opt = make_optimizer(ns.lr, ns.weight_decay)
    apply_fn = module_apply_fn(pipe.unet, mesh)
    base = dict(pipe.unet.named_parameters())
    layout = tp_layout(pipe.unet, ns.tp) if mesh is not None else {}
    if ns.lora_rank > 0:
        if is_vc:
            raise SystemExit("--lora-rank training currently supports ModelScope only")
        from t2v_torch.pipeline.lora import init_lora, save_stable_lora, unet_module_index

        lora_index = unet_module_index(unet_cfg)
        gen0 = torch.Generator(device=device).manual_seed(ns.seed)
        # A and B whole on every rank, from the same seed
        state = init_train_state(init_lora(base, lora_index, ns.lora_rank, gen0), opt, mesh)
        step_fn = make_lora_train_step(apply_fn, pipe.schedule, base, lora_index, mesh,
                                       alpha=ns.lora_alpha,
                                       parameterization=unet_cfg.parameterization,
                                       layout=layout)
    else:
        state = init_train_state(base, opt, mesh, with_ema=ns.ema_decay > 0, layout=layout)
        step_fn = make_train_step(apply_fn, pipe.schedule, mesh, ema_decay=ns.ema_decay or None,
                                  remat=ns.remat, parameterization=unet_cfg.parameterization)

    run_mode = {"lora_rank": ns.lora_rank, "ema": ns.ema_decay > 0}
    start_step = 0
    if ns.resume:
        resume_dir = latest_train_state(ns.out) if ns.resume == "auto" else ns.resume
        if resume_dir is None:
            raise SystemExit(f"--resume: no train state found under {ns.out}")
        saved_mode = train_state_mode(resume_dir)
        if saved_mode and saved_mode != run_mode:
            raise SystemExit(
                f"--resume: {resume_dir} was saved by a run with {saved_mode}, incompatible "
                f"with this run's {run_mode} (match --lora-rank/--ema-decay or start fresh)")
        state = restore_train_state(resume_dir, state)
        start_step = int(state.step)
        say(f"resumed from {resume_dir} at step {start_step}")
        if start_step >= ns.steps:
            say(f"already at step {start_step} >= --steps {ns.steps}; nothing to do")
            return 0

    ds = WebVidDataset(
        ns.data_dir, ns.meta_path, video_length=ns.frames,
        resolution=(ns.resolution, ns.resolution), frame_stride=ns.frame_stride,
        # a resumed run draws from a re-seeded shuffle rather than replaying
        # the clips and crops the first run already consumed
        seed=ns.seed + start_step,
    )
    say(f"dataset: {len(ds)} clips; device {device}, {policy.param_dtype}"
        + (f"; mesh dp={mesh.dp.size} sp={mesh.sp.size} tp={mesh.tp.size}" if mesh else ""))

    # this rank's samples and frames of each global batch
    dp_axis, sp_axis = (mesh.dp, mesh.sp) if mesh is not None else (None, None)
    samples = slice(None) if mesh is None else slice(
        dp_axis.index * ns.batch_size // dp_axis.size,
        (dp_axis.index + 1) * ns.batch_size // dp_axis.size)
    frames_of = slice(None) if mesh is None else slice(
        sp_axis.index * ns.frames // sp_axis.size, (sp_axis.index + 1) * ns.frames // sp_axis.size)
    # distinct diffusion noise and timesteps after a resume
    gen = torch.Generator(device=device).manual_seed(ns.seed + 7919 * start_step)
    step = start_step
    t0 = time.time()
    for frames, captions in ds.batches(ns.batch_size, epochs=10**6):
        latents = torch.cat([pipe.compute_latents(f[frames_of]) for f in frames[samples]], dim=0)
        context = torch.cat([encode_caption(c) for c in captions[samples]], dim=0)
        state, loss = step_fn(state, {"latents": latents, "context": context}, gen)
        step += 1
        if step % ns.log_every == 0:
            dt = time.time() - t0
            say(f"step {step} loss {float(loss):.4f} ({ns.log_every / dt:.2f} it/s)")
            t0 = time.time()
        if step % ns.save_every == 0 or step >= ns.steps:
            if ns.lora_rank > 0:
                out = f"{ns.out}/lora_step_{step}.safetensors"
                if primary:
                    os.makedirs(ns.out, exist_ok=True)
                    save_stable_lora(out, state.params, metadata={
                        "rank": ns.lora_rank, "alpha": ns.lora_alpha, "step": step})
            else:
                out = f"{ns.out}/step_{step}"
                trained = state.ema_params if state.ema_params is not None else state.params
                full = full_tensors(state, trained)  # on rank 0; every rank calls it
                if full is not None:
                    save_weights(
                        out, unet_params=full, vae=pipe.vae, clip=text_model, unet_cfg=unet_cfg,
                        vae_cfg=pipe.vae_cfg, clip_cfg=pipe.clip_cfg,
                        model_family="videocrafter" if is_vc else "modelscope",
                        tokenizer_vocab=vocab)
                del full
            # the full state for --resume; LoRA runs use a distinct dir name,
            # since a train-state-only step_N/ would look like a checkpoint
            state_dir = (f"{ns.out}/lora_state_{step}" if ns.lora_rank > 0
                         else f"{ns.out}/step_{step}")
            save_train_state(state_dir, state, mode=run_mode)
            say(f"saved {out}")
        if step >= ns.steps:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
