"""VideoCrafter (LVDM) text2video pipeline of the port.

The PyTorch counterpart of the JAX package's ``pipeline/videocrafter.py``
on its default branch: prompt -> CLIP-L text tower (77 tokens, EOS padded,
last hidden state, no prompt weighting) -> DDIM steps with fused
full-channel CFG on ``VideoCrafterUNet`` under the LVDM linear schedule ->
KL-VAE decode -> uint8 RGB frames. Everything runs on one device, the card
unless the caller asks for the CPU.

``random_init`` builds seeded random weights (no checkpoint needed) with
the JAX package's zero-initialised leaves; ``from_jax`` loads the JAX
package's parameter trees through ``io/convert.py``. The other branches of
the JAX pipeline (DDPM and DPM++ sampling, windowed execution with a
callback, T2I-Adapter features, mask inpainting, the ``uc_type`` CFG
variants, FPS conditioning, LoRA merging at load, checkpoint loading) are
not ported yet.
"""

from __future__ import annotations

import dataclasses
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
    sanity_check_args,
)
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion.sampling import sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule, beta_schedule
from t2v_torch.io import convert
from t2v_torch.models.conditioning import normalize_cond, route_conditioning
from t2v_torch.models.vae import AutoencoderKL
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet
from t2v_torch.pipeline.pipeline import (
    InferResult,
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
    vae: AutoencoderKL
    clip: HFCLIPTextModel
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule
    device: torch.device

    @staticmethod
    def configs(cfg: VideoCrafterUNetConfig | None, tokenizer: CLIPTokenizer,
                small_aux: bool | None = None):
        """(unet, vae, clip) configs of a random-weight pipeline: the full
        UNet with the SD VAE and the CLIP-L tower, or, with ``small_aux``
        (by default beside a UNet narrower than 128 channels), the tiny VAE
        and the two-layer, two-head tower that the JAX package's
        ``random_init`` builds."""
        cfg = cfg or VideoCrafterUNetConfig()
        if small_aux is None:
            small_aux = cfg.model_channels < 128
        vae_cfg = VAEConfig().tiny() if small_aux else VAEConfig()
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
    ) -> "VideoCrafterPipeline":
        """Random-weight pipeline (tests and smoke runs; no checkpoint on
        disk needed): the full-width model unless ``cfg`` says otherwise
        (``VideoCrafterUNetConfig().tiny()`` for a CPU-sized one).
        ``small_aux`` picks the tiny VAE and text tower beside any UNet. The
        tokenizer is ``CLIPTokenizer.for_tests()``."""
        tokenizer = CLIPTokenizer.for_tests()
        cfg, vae_cfg, clip_cfg = cls.configs(cfg, tokenizer, small_aux)

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

    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        """Plain CLIP-L encoding: 77 tokens, BOS/EOS, EOS-padded, last
        hidden state; no emphasis weighting."""
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
                f"VideoCrafterPipeline.infer: {', '.join(asked)} not ported yet; "
                "infer answers the default DDIM txt2vid branch")
        sanity_check_args(args)
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
