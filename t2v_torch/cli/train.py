"""Fine-tuning CLI of the port: WebVid data -> diffusion training on one GPU.

Clips are VAE-encoded on the device, captions text-encoded, and the train
step (``t2v_torch/parallel/train.py``) runs for either UNet family, as a
LoRA over the ModelScope UNet's linears or as a full fine-tune with an
optional EMA shadow. LoRA runs save reference-compatible stable-lora
``.safetensors``; full runs save the weights as safetensors (with the BPE
vocab, so that the directory loads with ``--model-dir``); both save the
full train state for ``--resume``. ``--model-dir`` fine-tunes a ModelScope
directory (the published layout or a saved one) in the device's dtype.

Usage:
  python -m t2v_torch.cli.train --data-dir /data/webvid --tiny \\
      --batch-size 2 --steps 100 --save-every 50 --out ckpts/

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
    p.add_argument("--model-dir", help="ModelScope model directory to fine-tune (the published "
                   "layout, or one this trainer saved); default: seeded random weights")
    p.add_argument("--model-type", default="ModelScope", choices=["ModelScope", "VideoCrafter"],
                   help="UNet family to train (both share the step)")
    p.add_argument("--vc-ckpt", help="not ported yet: the VideoCrafter loaders are a later slice")
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
                   help="sequence-parallel shards (not ported yet: the multi-GPU slice)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards (not ported yet: the multi-GPU slice)")
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


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.sp != 1 or ns.tp != 1:
        raise SystemExit("--sp/--tp: meshes are not ported yet (the multi-GPU slice); "
                         "the port trains on one device")
    if ns.vc_ckpt or (ns.model_dir and ns.model_type == "VideoCrafter"):
        raise SystemExit("--model-dir/--vc-ckpt: the VideoCrafter loaders are not ported yet "
                         "(the VideoCrafter slice); --model-dir loads ModelScope only, and "
                         "without either the UNet starts from seeded random weights")

    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, VideoCrafterUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.data.webvid import WebVidDataset
    from t2v_torch.io.train_state import (
        latest_train_state,
        restore_train_state,
        save_train_state,
        save_weights,
        train_state_mode,
    )
    from t2v_torch.parallel.train import (
        init_train_state,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
        module_apply_fn,
    )
    from t2v_torch.pipeline.pipeline import ModelScopePipeline, resolve_device

    device = resolve_device(ns.device)
    policy = Policy.bf16() if device.type == "cuda" else Policy.fp32()
    is_vc = ns.model_type == "VideoCrafter"
    if is_vc:
        from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

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
    apply_fn = module_apply_fn(pipe.unet)
    base = dict(pipe.unet.named_parameters())
    if ns.lora_rank > 0:
        if is_vc:
            raise SystemExit("--lora-rank training currently supports ModelScope only")
        from t2v_torch.pipeline.lora import init_lora, save_stable_lora, unet_module_index

        lora_index = unet_module_index(unet_cfg)
        gen0 = torch.Generator(device=device).manual_seed(ns.seed)
        state = init_train_state(init_lora(base, lora_index, ns.lora_rank, gen0), opt)
        step_fn = make_lora_train_step(apply_fn, pipe.schedule, base, lora_index,
                                       alpha=ns.lora_alpha,
                                       parameterization=unet_cfg.parameterization)
    else:
        state = init_train_state(base, opt, with_ema=ns.ema_decay > 0)
        step_fn = make_train_step(apply_fn, pipe.schedule, ema_decay=ns.ema_decay or None,
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
        print(f"resumed from {resume_dir} at step {start_step}")
        if start_step >= ns.steps:
            print(f"already at step {start_step} >= --steps {ns.steps}; nothing to do")
            return 0

    ds = WebVidDataset(
        ns.data_dir, ns.meta_path, video_length=ns.frames,
        resolution=(ns.resolution, ns.resolution), frame_stride=ns.frame_stride,
        # a resumed run draws from a re-seeded shuffle rather than replaying
        # the clips and crops the first run already consumed
        seed=ns.seed + start_step,
    )
    print(f"dataset: {len(ds)} clips; device {device}, {policy.param_dtype}")

    # distinct diffusion noise and timesteps after a resume
    gen = torch.Generator(device=device).manual_seed(ns.seed + 7919 * start_step)
    step = start_step
    t0 = time.time()
    for frames, captions in ds.batches(ns.batch_size, epochs=10**6):
        latents = torch.cat([pipe.compute_latents(f) for f in frames], dim=0)
        context = torch.cat([encode_caption(c) for c in captions], dim=0)
        state, loss = step_fn(state, {"latents": latents, "context": context}, gen)
        step += 1
        if step % ns.log_every == 0:
            dt = time.time() - t0
            print(f"step {step} loss {float(loss):.4f} ({ns.log_every / dt:.2f} it/s)")
            t0 = time.time()
        if step % ns.save_every == 0 or step >= ns.steps:
            if ns.lora_rank > 0:
                os.makedirs(ns.out, exist_ok=True)
                out = f"{ns.out}/lora_step_{step}.safetensors"
                save_stable_lora(out, state.params, metadata={
                    "rank": ns.lora_rank, "alpha": ns.lora_alpha, "step": step})
            else:
                out = f"{ns.out}/step_{step}"
                save_weights(
                    out, unet_params=state.ema_params if state.ema_params is not None
                    else state.params,
                    vae=pipe.vae, clip=text_model, unet_cfg=unet_cfg, vae_cfg=pipe.vae_cfg,
                    clip_cfg=pipe.clip_cfg,
                    model_family="videocrafter" if is_vc else "modelscope",
                    tokenizer_vocab=vocab)
            # the full state for --resume; LoRA runs use a distinct dir name,
            # since a train-state-only step_N/ would look like a checkpoint
            state_dir = (f"{ns.out}/lora_state_{step}" if ns.lora_rank > 0
                         else f"{ns.out}/step_{step}")
            save_train_state(state_dir, state, mode=run_mode)
            print(f"saved {out}")
        if step >= ns.steps:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
