"""VideoCrafter (LVDM) text2video pipeline of the port.

The PyTorch counterpart of the JAX package's ``pipeline/videocrafter.py``
on its default branch: prompt -> CLIP-L text tower (77 tokens, EOS padded,
last hidden state, no prompt weighting) -> DDIM steps with fused
full-channel CFG on ``VideoCrafterUNet`` under the LVDM linear schedule ->
KL-VAE decode -> uint8 RGB frames. Everything runs on one device, the card
unless the caller asks for the CPU.

``random_init`` builds seeded random weights (no checkpoint needed) with
the JAX package's zero-initialised leaves; ``from_jax`` loads the JAX
package's parameter trees through ``io/convert.py``. ``from_checkpoint``
loads the published Lightning ``model.ckpt`` with its ``model_config.yaml``
(UNet, SD VAE and CLIP-L from one file, weights-only and memory-mapped,
each tensor cast on the device as it loads), ``from_native`` a directory
the trainer saved, ``from_model_dir`` either; ``load_lora`` merges an LVDM
LoRA into the UNet; ``release_aux`` / ``reload_aux`` drop and re-read the
VAE and text tower ("Main Model Only"); ``load_vc_pipeline`` caches one
loaded pipeline. The other branches of the JAX pipeline (DDPM and DPM++
sampling, windowed execution with a callback, T2I-Adapter features, mask
inpainting, the ``uc_type`` CFG variants, FPS conditioning) are refused by
name until the VideoCrafter branches slice.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.core import rng as rng_lib
from t2v_torch.core.config import (
    CLIPTextConfig,
    T2VArgs,
    VAEConfig,
    VideoCrafterUNetConfig,
    config_from_dict,
    sanity_check_args,
)
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion.sampling import sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule, beta_schedule
from t2v_torch.io import convert, train_state, yaml_lite
from t2v_torch.io.convert_vc import split_lightning_state_dict, vc_module_index
from t2v_torch.models.conditioning import normalize_cond, route_conditioning
from t2v_torch.models.vae import AutoencoderKL
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet
from t2v_torch.pipeline import pipeline as ms_pipeline
from t2v_torch.pipeline.pipeline import (
    InferResult,
    _load_module,
    _spatial_scale,
    _sync,
    compute_latents,
    decode_latents,
    init_weights,
    resolve_device,
)
from t2v_torch.text.clip import HFCLIPTextModel
from t2v_torch.text.tokenizer import CLIPTokenizer

# sub-modules whose weights the JAX package initialises to zero
_TEMPORAL = tuple(f"{a}.{p}" for a in ("attn1_tmp", "attn2_tmp")
                  for p in ("to_q", "to_k", "to_v", "to_out.0"))
_ZERO_INIT = ("proj_out", "out_layers.3", "out.2", *_TEMPORAL)


def _routed_apply(unet: VideoCrafterUNet, conditioning_key: str | None, feats=None, tc=None):
    """(x, t, ctx) -> model output, routing ctx through the conditioning key
    (the reference's DiffusionWrapper dispatch). ``tc`` is the FPS
    ``temporal_context`` embedding carried by the cond dict."""

    def apply_fn(x, t, ctx):
        cond = normalize_cond(conditioning_key, ctx)
        if tc is not None:
            cond["temporal_context"] = tc
        x2, kw = route_conditioning(conditioning_key, x, cond)
        return unet(x2, t, kw["context"], features_adapter=feats, y=kw["y"],
                    temporal_context=kw["temporal_context"])

    return apply_fn


@dataclass
class VideoCrafterPipeline:
    cfg: VideoCrafterUNetConfig
    vae_cfg: VAEConfig
    clip_cfg: CLIPTextConfig
    policy: Policy
    unet: VideoCrafterUNet
    vae: AutoencoderKL | None  # None after release_aux
    clip: HFCLIPTextModel | None  # None after release_aux
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule
    device: torch.device
    # where reload_aux re-reads the VAE and text tower: the trainer's
    # directory, or the Lightning model.ckpt
    model_dir: str | None = None
    ckpt_path: str | None = None

    @staticmethod
    def configs(cfg: VideoCrafterUNetConfig | None, tokenizer: CLIPTokenizer,
                small_aux: bool | None = None, clip_cfg: CLIPTextConfig | None = None):
        """(unet, vae, clip) configs of a random-weight pipeline: the full
        UNet with the SD VAE and the CLIP-L tower, or, with ``small_aux``
        (by default beside a UNet narrower than 128 channels), the tiny VAE
        and the two-layer, two-head tower that the JAX package's
        ``random_init`` builds. A ``clip_cfg`` given is taken as it is."""
        cfg = cfg or VideoCrafterUNetConfig()
        if small_aux is None:
            small_aux = cfg.model_channels < 128
        vae_cfg = VAEConfig().tiny() if small_aux else VAEConfig()
        if clip_cfg is None:
            clip_cfg = dataclasses.replace(
                CLIPTextConfig.clip_l_14(), width=cfg.context_dim, vocab_size=tokenizer.vocab_size)
            if small_aux:
                clip_cfg = dataclasses.replace(clip_cfg, layers=2, heads=2)
        return cfg, vae_cfg, clip_cfg

    @classmethod
    def _build(cls, cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill) -> "VideoCrafterPipeline":
        dev = resolve_device(device)
        with torch.device(dev):
            unet, vae, clip = VideoCrafterUNet(cfg), AutoencoderKL(vae_cfg), HFCLIPTextModel(clip_cfg)
        fill(unet, vae, clip)
        dtype = policy.param_dtype
        unet, vae, clip = (m.to(dtype).eval() for m in (unet, vae, clip))
        schedule = DiffusionSchedule.from_betas(
            beta_schedule("linear", cfg.num_timesteps, cfg.linear_start, cfg.linear_end))
        return cls(cfg=cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, policy=policy, unet=unet, vae=vae,
                   clip=clip, tokenizer=tokenizer, schedule=schedule, device=dev)

    @classmethod
    def random_init(
        cls,
        cfg: VideoCrafterUNetConfig | None = None,
        policy: Policy = Policy(),
        seed: int = 0,
        device: torch.device | str = "cuda",
        small_aux: bool | None = None,
        *,
        clip_cfg: CLIPTextConfig | None = None,
    ) -> "VideoCrafterPipeline":
        """Random-weight pipeline (tests and smoke runs; no checkpoint on
        disk needed): the full-width model unless ``cfg`` says otherwise
        (``VideoCrafterUNetConfig().tiny()`` for a CPU-sized one).
        ``small_aux`` picks the tiny VAE and text tower beside any UNet;
        ``clip_cfg`` (e.g. CLIP-L with its published 49,408-row embedding)
        replaces the tower's config. The tokenizer is
        ``CLIPTokenizer.for_tests()``."""
        tokenizer = CLIPTokenizer.for_tests()
        cfg, vae_cfg, clip_cfg = cls.configs(cfg, tokenizer, small_aux, clip_cfg)

        def fill(unet, vae, clip):
            init_weights(unet, seed, _ZERO_INIT)
            init_weights(vae, seed + 1)
            init_weights(clip, seed + 2)

        return cls._build(cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    @classmethod
    def from_jax(
        cls, unet_params, vae_params, clip_params, cfg: VideoCrafterUNetConfig,
        policy: Policy = Policy(), device: torch.device | str = "cuda",
    ) -> "VideoCrafterPipeline":
        """Pipeline on the JAX package's parameter trees (numpy leaves) of a
        ``random_init`` pipeline with this UNet config."""
        tokenizer = CLIPTokenizer.for_tests()
        cfg, vae_cfg, clip_cfg = cls.configs(cfg, tokenizer)

        def fill(unet, vae, clip):
            convert.load_into(unet, convert.from_jax_vc_unet(unet_params, cfg))
            convert.load_into(vae, convert.from_jax_vae(vae_params, vae_cfg))
            convert.load_into(clip, convert.from_jax_clip(clip_params, clip_cfg, layout="hf"))

        return cls._build(cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    @classmethod
    def from_checkpoint(
        cls,
        ckpt_path: str,
        config_path: str | None = None,
        policy: Policy = Policy.bf16(),
        lora_path: str | None = None,
        lora_scale: float = 1.0,
        *,
        device: torch.device | str = "cuda",
    ) -> "VideoCrafterPipeline":
        """Load a published VideoCrafter ``model.ckpt`` (Lightning: one
        ``state_dict`` with the UNet, the SD VAE and the CLIP-L tower under
        their prefixes). The config is ``config_path``, else the
        ``model_config.yaml`` beside the checkpoint or in ``base_t2v/``; the
        vocab is found beside the checkpoint or in its parent. Each module is
        built on the meta device and each tensor cast to the policy's dtype
        on the device one at a time: no float32 copy reaches the card.
        The text tower is CLIP-L with as many layers as its keys hold. An
        FPS-conditioned config (``cond_stage2_config``) is refused."""
        dev = resolve_device(device)
        config_path = config_path or _find_config(ckpt_path)
        yaml_cfg = yaml_lite.load_file(config_path)
        cfg = VideoCrafterUNetConfig.from_yaml_dict(yaml_cfg)
        _refuse_fps(cfg, config_path)
        parts = split_lightning_state_dict(convert.load_torch_checkpoint(ckpt_path))
        unet = _load_module(lambda: VideoCrafterUNet(cfg), parts["unet"], policy, dev)
        sd_clip = _hf_clip_keys(parts["clip"])
        layers = 1 + max(int(k.split("encoder.layers.")[1].split(".")[0])
                         for k in sd_clip if "encoder.layers." in k)
        clip_cfg = dataclasses.replace(CLIPTextConfig.clip_l_14(), layers=layers)
        pipe = cls._loaded(cfg, VAEConfig.from_yaml_dict(yaml_cfg), clip_cfg, policy, unet,
                           CLIPTokenizer.find_and_load(os.path.dirname(ckpt_path),
                                                       os.path.dirname(os.path.dirname(ckpt_path))),
                           dev, ckpt_path=ckpt_path)
        pipe._load_aux(parts["vae"], sd_clip)
        if lora_path:
            skipped = pipe.load_lora(lora_path, lora_scale)
            print(f"t2v_torch: merged LVDM LoRA ({len(skipped)} modules skipped)")
        return pipe

    @classmethod
    def from_native(cls, model_dir: str, policy: Policy = Policy.bf16(), *,
                    device: torch.device | str = "cuda") -> "VideoCrafterPipeline":
        """Load what ``io/train_state.save_weights`` wrote for the
        VideoCrafter family: the configs from ``t2v_torch.json``, the weights
        from ``{unet,vae,clip}.safetensors``, the vocab beside them."""
        dev = resolve_device(device)
        meta, sds = train_state.load_weights(model_dir, only=("unet",))
        if meta.get("model_family") != "videocrafter":
            raise ValueError(f"{model_dir} holds a {meta.get('model_family')} checkpoint; load "
                             "it with ModelScopePipeline.from_native")
        cfg = config_from_dict(VideoCrafterUNetConfig, meta["unet_cfg"])
        _refuse_fps(cfg, model_dir)
        unet = _load_module(lambda: VideoCrafterUNet(cfg), sds["unet"], policy, dev)
        tokenizer = CLIPTokenizer.find_and_load(model_dir,
                                                os.path.dirname(os.path.abspath(model_dir)))
        pipe = cls._loaded(cfg, config_from_dict(VAEConfig, meta["vae_cfg"]),
                           config_from_dict(CLIPTextConfig, meta["clip_cfg"]), policy, unet,
                           tokenizer, dev, model_dir=model_dir)
        pipe.reload_aux()
        return pipe

    @classmethod
    def from_model_dir(cls, model_dir: str, policy: Policy = Policy.bf16(), *,
                       device: torch.device | str = "cuda", **kw) -> "VideoCrafterPipeline":
        """Either layout from a directory: one the trainer saved (its
        ``t2v_torch.json``), else the published ``model.ckpt`` (``kw`` go to
        ``from_checkpoint``). The one dispatch point of the CLI, ``run`` and
        the API."""
        if train_state.is_native_checkpoint(model_dir):
            return cls.from_native(model_dir, policy, device=device)
        return cls.from_checkpoint(os.path.join(model_dir, "model.ckpt"), policy=policy,
                                   device=device, **kw)

    @classmethod
    def _loaded(cls, cfg, vae_cfg, clip_cfg, policy, unet, tokenizer, dev, **where):
        schedule = DiffusionSchedule.from_betas(
            beta_schedule("linear", cfg.num_timesteps, cfg.linear_start, cfg.linear_end))
        return cls(cfg=cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, policy=policy, unet=unet,
                   vae=None, clip=None, tokenizer=tokenizer, schedule=schedule, device=dev,
                   **where)

    def load_lora(self, lora_path: str, scale: float = 1.0) -> list[str]:
        """Merge a cloneofsimo / LVDM LoRA file (``lora_up`` / ``lora_down``,
        ``.safetensors`` or a torch file, optionally under ``state_dict``)
        into the UNet in place: ``W += (up @ down) * scale``. Returns the
        skipped module names."""
        from t2v_torch.pipeline.lora import merge_lvdm_lora

        if lora_path.endswith(".safetensors"):
            from t2v_torch.io.safetensors_io import load_safetensors

            sd, _ = load_safetensors(lora_path)
        else:
            sd = convert.load_torch_checkpoint(lora_path)
            sd = sd.get("state_dict", sd)
        params = self.unet.state_dict()
        merged, skipped = merge_lvdm_lora(params, sd, vc_module_index(self.cfg), scale)
        with torch.no_grad():
            for name, t in merged.items():
                if t is not params[name]:
                    params[name].copy_(t)
        return skipped

    # ------------------------------------------------------------------
    # 'Main Model Only' retention: keep the UNet, drop the VAE and the text
    # tower between requests and read them again from where they came from

    def release_aux(self) -> None:
        """Drop the VAE and the text tower; on the card the caching
        allocator returns their memory to the device. ``reload_aux``
        restores them."""
        self.vae = None
        self.clip = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reload_aux(self) -> None:
        """Read the VAE and the text tower again, from the trainer's
        directory or the Lightning checkpoint (whose UNet part is mapped, not
        read); a no-op while both are resident."""
        if self.vae is not None and self.clip is not None:
            return
        if self.model_dir is None and self.ckpt_path is None:
            raise ValueError("cannot reload VAE/CLIP: pipeline has no checkpoint (random-init "
                             "pipelines cannot use 'Main Model Only')")
        if self.model_dir is not None:
            _, sds = train_state.load_weights(self.model_dir, only=("vae", "clip"))
            self._load_aux(sds["vae"], sds["clip"])
        else:
            parts = split_lightning_state_dict(convert.load_torch_checkpoint(self.ckpt_path))
            self._load_aux(parts["vae"], _hf_clip_keys(parts["clip"]))

    def _load_aux(self, sd_vae, sd_clip) -> None:
        self.vae = _load_module(lambda: AutoencoderKL(self.vae_cfg), sd_vae, self.policy,
                                self.device)
        self.clip = _load_module(lambda: HFCLIPTextModel(self.clip_cfg), sd_clip, self.policy,
                                 self.device)

    def _require_aux(self) -> None:
        if self.vae is None or self.clip is None:
            raise ValueError("the VAE and text tower were released (release_aux); call "
                             "reload_aux() first")

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        """Plain CLIP-L encoding: 77 tokens, BOS/EOS, EOS-padded, last
        hidden state; no emphasis weighting."""
        self._require_aux()
        length = self.clip_cfg.context_length
        rows = []
        for p in prompts:
            ids = self.tokenizer.encode(p)[: length - 2]
            row = [self.tokenizer.bos_id] + ids + [self.tokenizer.eos_id]
            rows.append(row + [self.tokenizer.eos_id] * (length - len(row)))
        tokens = torch.tensor(rows, dtype=torch.long, device=self.device)
        return self.clip(tokens)

    def make_apply_fn(self, features_adapter=None, temporal_context=None):
        """(x, t, ctx) -> eps, routing ctx through the model's
        conditioning key."""
        return _routed_apply(self.unet, self.cfg.conditioning_key, features_adapter,
                             temporal_context)

    def compute_latents(self, frames_rgb) -> torch.Tensor:
        """(F, H, W, 3) float in [-1, 1] -> (1, F, h, w, 4) scaled latents:
        the LVDM frame-batched encode, posterior mean x scale factor."""
        return compute_latents(self.vae, frames_rgb, float(self.cfg.scale_factor), self.device)

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(F, h, w, 4) scaled latents -> (F, H, W, 3) uint8 RGB."""
        return decode_latents(self.vae, self.vae_cfg, latents, float(self.cfg.scale_factor))

    def infer(
        self,
        args: T2VArgs,
        *,
        callback=None,
        callback_interval: int | None = None,
        batch_index: int = 0,
        sample_type: str = "ddim",
        features_adapter=None,
        mask=None,
        source_latents=None,
        uc_type: str | None = None,
        noise: torch.Tensor | None = None,
    ) -> InferResult:
        """Answer one request on the default branch: whole-loop DDIM with
        full-channel CFG. ``noise`` replaces the seeded starting latent
        (tests hand both packages the same numpy noise). The arguments of
        the other branches are accepted and refused by name."""
        later = {
            "callback": callback is not None or callback_interval is not None,
            "sample_type other than 'ddim'": sample_type != "ddim",
            "features_adapter": features_adapter is not None,
            "mask / source_latents": mask is not None or source_latents is not None,
            "uc_type": uc_type is not None,
            "cond_fps on an FPS-conditioned model": self.cfg.cond_stage2_key is not None,
        }
        asked = [name for name, given in later.items() if given]
        if asked:
            raise NotImplementedError(
                f"VideoCrafterPipeline.infer: {', '.join(asked)} not ported yet (the "
                "VideoCrafter branches slice); infer answers the default DDIM txt2vid branch")
        sanity_check_args(args)
        self._require_aux()
        seed = rng_lib.resolve_seed(args.seed)
        batch_seed = rng_lib.batch_seed(seed, batch_index) if args.seed != -1 else seed
        ss = _spatial_scale(self.vae_cfg)
        shape = (1, args.frames, args.height // ss, args.width // ss, self.cfg.in_channels)
        dev = self.device

        t0 = time.perf_counter()
        cond = self.encode_text([args.prompt])
        uncond = self.encode_text([args.n_prompt])
        _sync(dev)
        t_text = time.perf_counter() - t0

        t0 = time.perf_counter()
        gen = rng_lib.generator(batch_seed, dev)
        if noise is None:
            noise = rng_lib.latent_noise(gen, shape, dev)
        x0 = sample_loop(
            self.make_apply_fn(), self.schedule, steps=args.steps, shape=shape, cond=cond,
            uncond=uncond, guidance_scale=args.cfg_scale, eta=args.eta, sampler_name="DDIM",
            generator=gen, noise=noise.to(dev), device=dev,
            parameterization=self.cfg.parameterization,
        )
        _sync(dev)
        t_sample = time.perf_counter() - t0

        t0 = time.perf_counter()
        frames = self.decode_latents(x0[0])
        t_decode = time.perf_counter() - t0
        return InferResult(
            frames=frames, latents=x0, infotext=self.create_infotext(args, batch_seed),
            timings={"text": t_text, "sample": t_sample, "decode": t_decode},
        )

    def create_infotext(self, args: T2VArgs, seed: int) -> str:
        return (
            f"{args.prompt}\nNegative prompt: {args.n_prompt}\n"
            f"Steps: {args.steps}, Sampler: DDIM, CFG scale: {args.cfg_scale}, "
            f"Seed: {seed}, Size: {args.width}x{args.height}, "
            f"Frames: {args.frames}, Model: VideoCrafter"
        )


def _find_config(ckpt_path: str) -> str:
    """The ``model_config.yaml`` beside the checkpoint, or in ``base_t2v/``
    beside it."""
    here = os.path.dirname(ckpt_path)
    for cand in (os.path.join(here, "model_config.yaml"),
                 os.path.join(here, "base_t2v", "model_config.yaml")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"model_config.yaml not found near {ckpt_path}")


def _refuse_fps(cfg: VideoCrafterUNetConfig, where: str) -> None:
    if cfg.cond_stage2_key is not None:
        raise NotImplementedError(
            f"{where}: an FPS-conditioned VideoCrafter model (cond_stage2_config) is not "
            "ported yet (the VideoCrafter branches slice)")


def _hf_clip_keys(sd) -> dict:
    """The text tower's keys under ``text_model.`` whatever wraps them."""
    return {f"text_model.{k.split('text_model.')[-1]}": v for k, v in sd.items()}


def load_vc_pipeline(model_dir: str, policy: Policy = Policy.bf16(), keep_in_vram: bool = True,
                     device: torch.device | str = "cuda") -> VideoCrafterPipeline:
    """``VideoCrafterPipeline.from_model_dir`` through
    ``pipeline.cached_pipeline``, the one cache of both families."""
    return ms_pipeline.cached_pipeline("videocrafter", VideoCrafterPipeline.from_model_dir,
                                       model_dir, policy, keep_in_vram, device)
