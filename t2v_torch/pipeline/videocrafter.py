"""VideoCrafter (LVDM) text2video pipeline of the port.

The PyTorch counterpart of the JAX package's ``pipeline/videocrafter.py``:
prompt -> CLIP-L text tower (77 tokens, EOS padded, last hidden state, no
prompt weighting) -> denoising on ``VideoCrafterUNet`` under the LVDM linear
schedule -> KL-VAE decode -> uint8 RGB frames. Everything runs on one
device, the card unless the caller asks for the CPU.

``infer`` answers every branch of the JAX pipeline: DDIM (the default, with
full-channel CFG or the ``uc_type`` variants ``cfg_original`` /
``cfg_ours``), the full-chain ancestral DDPM, DPM++ 2M; a step callback
every ``callback_interval`` steps (DDIM and DPM++ 2M; the port's loop is the
same Python loop with or without it, so a windowed request is bit-identical
to the whole one); LVDM's static mask inpainting (``mask`` 1 keeps
``source_latents``, from ``build_inpainting_inputs``); T2I-Adapter features
(``load_adapter`` / ``adapter_features``); and FPS conditioning (the
``cond_stage2`` embedder, ``embed_fps``, fed by ``args.cond_fps``).

``random_init`` builds seeded random weights (no checkpoint needed) with
the JAX package's zero-initialised leaves; ``from_jax`` loads the JAX
package's parameter trees through ``io/convert.py``. ``from_checkpoint``
loads the published Lightning ``model.ckpt`` with its ``model_config.yaml``
(UNet, SD VAE, CLIP-L and an FPS embedder from one file, weights-only and
memory-mapped, each tensor cast on the device as it loads), ``from_native``
a directory the trainer saved, ``from_model_dir`` either; ``load_lora``
merges an LVDM LoRA into the UNet; ``release_aux`` / ``reload_aux`` drop and
re-read the VAE and text tower ("Main Model Only"); ``load_vc_pipeline``
caches one loaded pipeline.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
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
from t2v_torch.core.profiling import PhaseTimes, span
from t2v_torch.diffusion import ddpm
from t2v_torch.diffusion.sampling import make_eps_fn, sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule, beta_schedule
from t2v_torch.io import convert, train_state, yaml_lite
from t2v_torch.io.convert_vc import (
    fps_embedder_state,
    split_lightning_state_dict,
    vc_module_index,
)
from t2v_torch.models.adapter import Adapter, AdapterConfig, infer_adapter_config
from t2v_torch.models.conditioning import normalize_cond, route_conditioning
from t2v_torch.models.vae import AutoencoderKL
from t2v_torch.models.videocrafter_unet import FPSEmbedder, VideoCrafterUNet
from t2v_torch.pipeline import pipeline as ms_pipeline
from t2v_torch.pipeline.keyframes import KeyFrameSeries
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

SAMPLE_TYPES = ("ddim", "ddpm", "dpm++ 2m")

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
    # the cond_stage2 FPS embedder of an FPS-conditioned model
    fps_embedder: FPSEmbedder | None = None

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
    def _build(cls, cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill, fill_fps,
               label_dim=None) -> "VideoCrafterPipeline":
        dev = resolve_device(device)
        with torch.device(dev):
            unet, vae, clip = (VideoCrafterUNet(cfg, label_dim), AutoencoderKL(vae_cfg),
                               HFCLIPTextModel(clip_cfg))
            fps = FPSEmbedder(cfg.model_channels) if _fps_conditioned(cfg) else None
        fill(unet, vae, clip)
        if fps is not None:
            fill_fps(fps)
            fps = fps.to(policy.param_dtype).eval()
        dtype = policy.param_dtype
        unet, vae, clip = (m.to(dtype).eval() for m in (unet, vae, clip))
        return cls(cfg=cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, policy=policy, unet=unet, vae=vae,
                   clip=clip, tokenizer=tokenizer, schedule=_schedule(cfg), device=dev,
                   fps_embedder=fps)

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
        label_dim: int | None = None,
    ) -> "VideoCrafterPipeline":
        """Random-weight pipeline (tests and smoke runs; no checkpoint on
        disk needed): the full-width model unless ``cfg`` says otherwise
        (``VideoCrafterUNetConfig().tiny()`` for a CPU-sized one).
        ``small_aux`` picks the tiny VAE and text tower beside any UNet;
        ``clip_cfg`` (e.g. CLIP-L with its published 49,408-row embedding)
        replaces the tower's config; ``label_dim`` gives the UNet a
        ``label_proj`` for embedding-valued ``y`` of that width. An
        FPS-conditioned ``cfg`` gets a seeded FPS embedder. The tokenizer is
        ``CLIPTokenizer.for_tests()``."""
        tokenizer = CLIPTokenizer.for_tests()
        cfg, vae_cfg, clip_cfg = cls.configs(cfg, tokenizer, small_aux, clip_cfg)

        def fill(unet, vae, clip):
            init_weights(unet, seed, _ZERO_INIT)
            init_weights(vae, seed + 1)
            init_weights(clip, seed + 2)

        return cls._build(cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill,
                          lambda fps: init_weights(fps, seed + 3), label_dim)

    @classmethod
    def from_jax(
        cls, unet_params, vae_params, clip_params, cfg: VideoCrafterUNetConfig,
        policy: Policy = Policy(), device: torch.device | str = "cuda", fps_params=None,
    ) -> "VideoCrafterPipeline":
        """Pipeline on the JAX package's parameter trees (numpy leaves) of a
        ``random_init`` pipeline with this UNet config (and its FPS
        embedder's, ``fps_params``, when the config is FPS-conditioned)."""
        from t2v_torch.io.convert_vc import from_jax_fps_embedder

        tokenizer = CLIPTokenizer.for_tests()
        cfg, vae_cfg, clip_cfg = cls.configs(cfg, tokenizer)

        def fill(unet, vae, clip):
            convert.load_into(unet, convert.from_jax_vc_unet(unet_params, cfg))
            convert.load_into(vae, convert.from_jax_vae(vae_params, vae_cfg))
            convert.load_into(clip, convert.from_jax_clip(clip_params, clip_cfg, layout="hf"))

        return cls._build(cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill,
                          lambda fps: convert.load_into(fps, from_jax_fps_embedder(fps_params)))

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
        FPS-conditioned config (``cond_stage2_config``) loads its embedder
        from the ``cond_stage2_model.*`` weights; a checkpoint without them
        gets a seeded fresh embedder and a warning, as the JAX package's
        loader does."""
        dev = resolve_device(device)
        config_path = config_path or _find_config(ckpt_path)
        yaml_cfg = yaml_lite.load_file(config_path)
        cfg = VideoCrafterUNetConfig.from_yaml_dict(yaml_cfg)
        parts = split_lightning_state_dict(convert.load_torch_checkpoint(ckpt_path))
        unet = _load_module(lambda: VideoCrafterUNet(cfg, _label_dim(parts["unet"])),
                            parts["unet"], policy, dev)
        sd_clip = _hf_clip_keys(parts["clip"])
        layers = 1 + max(int(k.split("encoder.layers.")[1].split(".")[0])
                         for k in sd_clip if "encoder.layers." in k)
        clip_cfg = dataclasses.replace(CLIPTextConfig.clip_l_14(), layers=layers)
        pipe = cls._loaded(cfg, VAEConfig.from_yaml_dict(yaml_cfg), clip_cfg, policy, unet,
                           CLIPTokenizer.find_and_load(os.path.dirname(ckpt_path),
                                                       os.path.dirname(os.path.dirname(ckpt_path))),
                           dev, ckpt_path=ckpt_path)
        pipe.fps_embedder = _load_fps_embedder(cfg, fps_embedder_state(parts["other"], cfg),
                                               policy, dev, ckpt_path)
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
        from ``{unet,vae,clip}.safetensors``, the vocab beside them. The
        trainer saves no FPS embedder: an FPS-conditioned config gets a
        seeded fresh one and a warning."""
        dev = resolve_device(device)
        meta, sds = train_state.load_weights(model_dir, only=("unet",))
        if meta.get("model_family") != "videocrafter":
            raise ValueError(f"{model_dir} holds a {meta.get('model_family')} checkpoint; load "
                             "it with ModelScopePipeline.from_native")
        cfg = config_from_dict(VideoCrafterUNetConfig, meta["unet_cfg"])
        unet = _load_module(lambda: VideoCrafterUNet(cfg, _label_dim(sds["unet"])), sds["unet"],
                            policy, dev)
        tokenizer = CLIPTokenizer.find_and_load(model_dir,
                                                os.path.dirname(os.path.abspath(model_dir)))
        pipe = cls._loaded(cfg, config_from_dict(VAEConfig, meta["vae_cfg"]),
                           config_from_dict(CLIPTextConfig, meta["clip_cfg"]), policy, unet,
                           tokenizer, dev, model_dir=model_dir)
        pipe.fps_embedder = _load_fps_embedder(cfg, None, policy, dev, model_dir)
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
        return cls(cfg=cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, policy=policy, unet=unet,
                   vae=None, clip=None, tokenizer=tokenizer, schedule=_schedule(cfg),
                   device=dev, **where)

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
        """(x, t, ctx) -> eps, routing ctx through the model's conditioning
        key, with adapter features and the FPS embedding when given."""
        return _routed_apply(self.unet, self.cfg.conditioning_key, features_adapter,
                             temporal_context)

    def compute_latents(self, frames_rgb) -> torch.Tensor:
        """(F, H, W, 3) float in [-1, 1] -> (1, F, h, w, 4) scaled latents:
        the LVDM frame-batched encode, posterior mean x scale factor."""
        return compute_latents(self.vae, frames_rgb, float(self.cfg.scale_factor), self.device)

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(F, h, w, 4) scaled latents -> (F, H, W, 3) uint8 RGB."""
        return decode_latents(self.vae, self.vae_cfg, latents, float(self.cfg.scale_factor))

    def apply_model(self, x, t, cond, features_adapter=None):
        """LVDM's ``apply_model``: ``cond`` is a bare context tensor, a list,
        or a conditioning dict (``c_concat`` / ``c_crossattn`` / ``c_adm`` /
        ``s`` / ``temporal_context``), routed by the conditioning key."""
        ck = self.cfg.conditioning_key
        x2, kw = route_conditioning(ck, x, normalize_cond(ck, cond))
        return self.unet(x2, t, kw["context"], features_adapter=features_adapter, y=kw["y"],
                         temporal_context=kw["temporal_context"])

    # ------------------------------------------------------------------
    # T2I-Adapter and FPS conditioning

    def load_adapter(self, adapter_path: str, adapter_cfg: AdapterConfig | None = None) -> Adapter:
        """A T2I-Adapter checkpoint (a torch file, optionally under
        ``state_dict``, or ``.safetensors``; an ``adapter.`` prefix is
        stripped) on the pipeline's device and dtype. The config is read
        from the keys unless given. A missing or malformed file raises,
        naming it."""
        if adapter_path.endswith(".safetensors"):
            from t2v_torch.io.safetensors_io import load_safetensors

            sd, _ = load_safetensors(adapter_path)
        else:
            sd = convert.load_torch_checkpoint(adapter_path)
        sd = sd.get("state_dict", sd)
        sd = {(k[len("adapter."):] if k.startswith("adapter.") else k): v for k, v in sd.items()}
        try:
            cfg = adapter_cfg or infer_adapter_config(sd)
            return _load_module(lambda: Adapter(cfg), sd, self.policy, self.device)
        except (KeyError, ValueError, RuntimeError) as e:
            raise ValueError(f"{adapter_path}: not a T2I-Adapter checkpoint ({e})") from None

    @torch.no_grad()
    def adapter_features(self, adapter: Adapter, depth_video) -> tuple[torch.Tensor, ...]:
        """The adapter's feature pyramid of every frame. ``depth_video``:
        (B, T, H, W, C) in [-1, 1], depth maps normalised per frame. The
        frames fold into the batch for one adapter pass; each feature comes
        back as (B, T, h, w, c) in the UNet's channels-last layout."""
        d = torch.as_tensor(depth_video, dtype=torch.float32).to(self.device)
        b, t = d.shape[:2]
        feats = adapter(d.reshape(b * t, *d.shape[2:]))
        return tuple(f.reshape(b, t, *f.shape[1:]) for f in feats)

    @torch.no_grad()
    def embed_fps(self, fps) -> torch.Tensor:
        """The (1, 4·model_channels) ``temporal_context`` embedding of a
        frame rate, from the model's FPS embedder."""
        if self.fps_embedder is None:
            raise ValueError("this model has no cond_stage2 FPS embedder "
                             "(cfg.cond_stage2_key is unset)")
        return self.fps_embedder(torch.tensor([float(fps)]))

    def _resolve_temporal_context(self, args: T2VArgs):
        """``args.cond_fps`` -> the FPS embedding on an FPS-conditioned
        model (which requires it), else None."""
        if not _fps_conditioned(self.cfg):
            return None
        if args.cond_fps is None:
            raise ValueError("this VideoCrafter model is FPS-conditioned: set cond_fps")
        return self.embed_fps(args.cond_fps)

    # ------------------------------------------------------------------

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
        step_noise=None,
        inpaint_noise=None,
        ddpm_noise=None,
    ) -> InferResult:
        """Answer one request.

        sample_type: "ddim" (the default), "ddpm" (the full ancestral chain,
        no callback) or "dpm++ 2m" (txt2vid only: no mask, no uc_type).
        callback(done) runs every ``callback_interval`` steps and after the
        last (it may raise to stop the request). features_adapter: the
        adapter's feature pyramid (``adapter_features``). mask: (1, F, h, w,
        C), 1 keeps ``source_latents`` (``build_inpainting_inputs``), blended
        back after every DDIM step. uc_type: None (full CFG), "cfg_original"
        or "cfg_ours". ``noise`` replaces the seeded starting latent, and
        ``step_noise[i]`` / ``inpaint_noise[i]`` / ``ddpm_noise[i]`` the
        seeded draws of step i (tests hand in the JAX package's)."""
        sanity_check_args(args)
        if sample_type not in SAMPLE_TYPES:
            raise ValueError(f"unknown sample_type {sample_type!r} (one of {SAMPLE_TYPES})")
        if sample_type == "dpm++ 2m" and (mask is not None or uc_type):
            raise ValueError("sample_type='dpm++ 2m' does not support mask inpainting or uc_type "
                             "CFG variants — use 'ddim'")
        if sample_type == "ddpm" and callback is not None:
            raise ValueError("sample_type='ddpm' runs the whole chain and takes no callback")
        self._require_aux()
        seed = rng_lib.resolve_seed(args.seed)
        batch_seed = rng_lib.batch_seed(seed, batch_index) if args.seed != -1 else seed
        ss = _spatial_scale(self.vae_cfg)
        shape = (1, args.frames, args.height // ss, args.width // ss, self.cfg.in_channels)
        dev = self.device

        pt = PhaseTimes()
        with span("t2v.request", str(batch_seed)):
            with pt.phase("text"):
                cond = self.encode_text([args.prompt])
                uncond = self.encode_text([args.n_prompt])
                tc = self._resolve_temporal_context(args)
                _sync(dev)

            with pt.phase("sample"):
                gen = rng_lib.generator(batch_seed, dev)
                if noise is None:
                    noise = rng_lib.latent_noise(gen, shape, dev)
                noise = noise.to(dev)
                apply_fn = self.make_apply_fn(features_adapter, tc)
                if sample_type == "ddpm":
                    eps_fn = make_eps_fn(apply_fn, cond, uncond, args.cfg_scale, "full",
                                         self.cfg.parameterization, self.schedule)
                    # LVDM's latent diffusion does not clip x0 (latents exceed +-1)
                    x0 = ddpm.sample(eps_fn, self.schedule, noise, generator=gen,
                                     noise_table=ddpm_noise, clip_denoised=False)
                else:
                    # the blend needs both; a mask alone selects it and blends nothing
                    blend = mask is not None
                    x0 = sample_loop(
                        apply_fn, self.schedule, steps=args.steps, shape=shape, cond=cond,
                        uncond=uncond, guidance_scale=args.cfg_scale, eta=args.eta,
                        sampler_name="DPM++ 2M" if sample_type == "dpm++ 2m" else "DDIM",
                        generator=gen, noise=noise, device=dev,
                        mask=mask.to(dev) if blend else None,
                        image_latents=None if source_latents is None else source_latents.to(dev),
                        inpaint_mode="lvdm_static" if blend else "initial_only",
                        cfg_combine_mode=uc_type, parameterization=self.cfg.parameterization,
                        callback=callback, callback_interval=callback_interval,
                        step_noise=step_noise, inpaint_noise=inpaint_noise,
                    )
                _sync(dev)

            with pt.phase("decode"):
                frames = self.decode_latents(x0[0])
        return InferResult(
            frames=frames, latents=x0, infotext=self.create_infotext(args, batch_seed),
            timings=dict(pt.times),
        )

    def build_inpainting_inputs(self, image_rgb, args: T2VArgs) -> tuple[torch.Tensor, torch.Tensor]:
        """img2vid inputs of LVDM's static mask blend: (mask, source_latents),
        each (1, F, h, w, C) float32. The keyframe weights of
        ``args.inpainting_weights`` say how much of frame i is generated, so
        frame i keeps the source with weight 1 - w_i (mask 1 keeps); the
        source image (H, W, 3 uint8) is encoded once per frame."""
        ss = _spatial_scale(self.vae_cfg)
        lat_h, lat_w = args.height // ss, args.width // ss
        keys = KeyFrameSeries(args.frames, args.seed, max(args.inpainting_frames, 1))
        weights = keys.inpainting_weights(args.inpainting_weights)
        img = np.asarray(image_rgb, np.float32) / 255.0 * 2.0 - 1.0
        source_latents = self.compute_latents(np.repeat(img[None], args.frames, axis=0))
        keep = (1.0 - np.asarray(weights, np.float64)).astype(np.float32)
        mask = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            keep.reshape(1, -1, 1, 1, 1), (1, args.frames, lat_h, lat_w, self.cfg.in_channels))))
        return mask.to(self.device), source_latents

    def create_infotext(self, args: T2VArgs, seed: int) -> str:
        return (
            f"{args.prompt}\nNegative prompt: {args.n_prompt}\n"
            f"Steps: {args.steps}, Sampler: DDIM, CFG scale: {args.cfg_scale}, "
            f"Seed: {seed}, Size: {args.width}x{args.height}, "
            f"Frames: {args.frames}, Model: VideoCrafter"
        )


def _fps_conditioned(cfg: VideoCrafterUNetConfig) -> bool:
    return cfg.cond_stage2_key == "temporal_context"


def _schedule(cfg: VideoCrafterUNetConfig) -> DiffusionSchedule:
    return DiffusionSchedule.from_betas(
        beta_schedule("linear", cfg.num_timesteps, cfg.linear_start, cfg.linear_end))


def _label_dim(sd) -> int | None:
    """The width of ``y`` that a UNet state dict's ``label_proj`` takes."""
    w = sd.get("label_proj.weight")
    return None if w is None else int(w.shape[1])


def _load_fps_embedder(cfg, sd, policy, dev, where: str) -> FPSEmbedder | None:
    """The FPS embedder of an FPS-conditioned ``cfg`` from ``sd``, else a
    seeded fresh one with a warning; None for other models."""
    if not _fps_conditioned(cfg):
        return None
    if sd is not None:
        return _load_module(lambda: FPSEmbedder(cfg.model_channels), sd, policy, dev)
    warnings.warn(f"{where}: the model is FPS-conditioned (cond_stage2) but carries no "
                  "compatible cond_stage2_model weights; initialising the FPS embedder randomly")
    with torch.device(dev):
        fps = FPSEmbedder(cfg.model_channels)
    init_weights(fps, 0)
    return fps.to(policy.param_dtype).eval()


def _find_config(ckpt_path: str) -> str:
    """The ``model_config.yaml`` beside the checkpoint, or in ``base_t2v/``
    beside it."""
    here = os.path.dirname(ckpt_path)
    for cand in (os.path.join(here, "model_config.yaml"),
                 os.path.join(here, "base_t2v", "model_config.yaml")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"model_config.yaml not found near {ckpt_path}")


def _hf_clip_keys(sd) -> dict:
    """The text tower's keys under ``text_model.`` whatever wraps them."""
    return {f"text_model.{k.split('text_model.')[-1]}": v for k, v in sd.items()}


def load_vc_pipeline(model_dir: str, policy: Policy = Policy.bf16(), keep_in_vram: bool = True,
                     device: torch.device | str = "cuda") -> VideoCrafterPipeline:
    """``VideoCrafterPipeline.from_model_dir`` through
    ``pipeline.cached_pipeline``, the one cache of both families."""
    return ms_pipeline.cached_pipeline("videocrafter", VideoCrafterPipeline.from_model_dir,
                                       model_dir, policy, keep_in_vram, device)
