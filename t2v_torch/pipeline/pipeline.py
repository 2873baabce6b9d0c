"""End-to-end ModelScope text2video pipeline of the port.

The PyTorch counterpart of the JAX package's ``pipeline/pipeline.py`` on
its default path: text encode -> fused-CFG DDIM_Gaussian step loop ->
frame-batched VAE decode -> uint8 RGB frames. Everything runs on one
device, the card unless the caller asks for the CPU. Seed policy: the
request's seed, ``-1`` resolved to a fresh one, ``seed + batch_index`` per
batch.

``random_init`` builds seeded random weights (no checkpoint needed) with
the JAX package's zero-initialised leaves; ``from_jax`` loads the JAX
package's parameter trees through ``io/convert.py``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from t2v_torch.core import rng as rng_lib
from t2v_torch.core.config import (
    CLIPTextConfig,
    ModelScopeUNetConfig,
    T2VArgs,
    VAEConfig,
    sanity_check_args,
)
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion.sampling import sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.io import convert
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.models.vae import AutoencoderKL, decode_uint8
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.encoder import TextEncoder
from t2v_torch.text.tokenizer import CLIPTokenizer

SCALE_FACTOR = 0.18215  # latent scaling
# frames per VAE decode call follow the output pixel volume, as in the JAX
# package: 8M pixels per call decodes 24 frames at 256x256 in one call
DECODE_PIXEL_BUDGET = 8_000_000


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; asking for CUDA on a host without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "t2v_torch: CUDA was asked for but no GPU is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spatial_scale(vae_cfg: VAEConfig) -> int:
    return 2 ** (len(vae_cfg.ch_mult) - 1)


def decode_chunk_frames(n: int, h_img: int, w_img: int) -> int:
    """Frames per VAE decode call for ``n`` frames of h_img x w_img pixels:
    the pixel budget's share, balanced over the calls so that the
    zero-padded tail of the last one stays small."""
    step_f = max(1, DECODE_PIXEL_BUDGET // max(1, h_img * w_img))
    if n > step_f:
        step_f = -(-n // -(-n // step_f))
    return step_f


@torch.no_grad()
def decode_latents(vae: AutoencoderKL, vae_cfg: VAEConfig, latents: torch.Tensor,
                   scale_factor: float = SCALE_FACTOR) -> np.ndarray:
    """(F, h, w, 4) scaled latents -> (F, H, W, 3) uint8 RGB, decoded in
    frame chunks that bound the decoder's activation memory."""
    up = _spatial_scale(vae_cfg)
    n = latents.shape[0]
    step_f = decode_chunk_frames(n, latents.shape[1] * up, latents.shape[2] * up)
    outs = []
    for i in range(0, n, step_f):
        chunk = latents[i : i + step_f]
        pad = step_f - chunk.shape[0] if n > step_f else 0
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
        img = decode_uint8(vae, chunk, scale_factor)
        outs.append(img[: img.shape[0] - pad].cpu().numpy())
    return np.concatenate(outs, axis=0)


# sub-modules whose weights the JAX package initialises to zero
_ZERO_INIT = ("proj_out", "out_layers.3", "temopral_conv.conv4.3", "out.2")


@torch.no_grad()
def init_weights(module: nn.Module, seed: int, zero_init: tuple[str, ...] = ()) -> None:
    """Seeded random init in the JAX package's scheme: weights normal with
    std 1/sqrt(fan_in), biases 0, norm scales 1, the CLIP positional
    embedding normal(0.01); parameters of a sub-module named in
    ``zero_init`` are 0. Draws on the module's device."""
    gen = None
    for name, p in module.named_parameters():
        if gen is None:
            gen = torch.Generator(device=p.device)
            gen.manual_seed(seed)
        owner = name.rsplit(".", 1)[0]
        zero = any(owner == z or owner.endswith("." + z) for z in zero_init)
        if name.endswith("bias") or zero:
            p.zero_()
        elif name == "positional_embedding":
            p.normal_(0.0, 0.01, generator=gen)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p.shape[1] if name.endswith("embedding.weight") else p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=gen)


@dataclass
class InferResult:
    frames: np.ndarray  # (F, H, W, 3) uint8 RGB
    latents: torch.Tensor  # final denoised latents (1, F, h, w, 4), float32
    infotext: str
    timings: dict = field(default_factory=dict)  # seconds: text, sample, decode


@dataclass
class ModelScopePipeline:
    unet_cfg: ModelScopeUNetConfig
    vae_cfg: VAEConfig
    clip_cfg: CLIPTextConfig
    policy: Policy
    unet: UNetSD
    vae: AutoencoderKL
    text_encoder: TextEncoder
    schedule: DiffusionSchedule
    device: torch.device

    @staticmethod
    def configs(unet_cfg: ModelScopeUNetConfig | None, tokenizer: CLIPTokenizer):
        """(unet, vae, clip) configs of a random-weight pipeline, chosen as
        the JAX package's ``random_init`` chooses them: the tiny VAE and
        text tower beside a tiny UNet, the full ones beside a full UNet."""
        unet_cfg = unet_cfg or ModelScopeUNetConfig().tiny()
        small = unet_cfg.dim < 128
        vae_cfg = VAEConfig().tiny() if small else VAEConfig()
        clip_cfg = CLIPTextConfig.vit_h_14().tiny() if small else CLIPTextConfig.vit_h_14()
        clip_cfg = dataclasses.replace(
            clip_cfg, width=unet_cfg.context_dim, vocab_size=tokenizer.vocab_size
        )
        return unet_cfg, vae_cfg, clip_cfg

    @classmethod
    def _build(cls, unet_cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill) -> "ModelScopePipeline":
        dev = resolve_device(device)
        with torch.device(dev):
            unet, vae, clip = UNetSD(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextTransformer(clip_cfg)
        fill(unet, vae, clip)
        dtype = policy.param_dtype
        unet, vae, clip = (m.to(dtype).eval() for m in (unet, vae, clip))
        return cls(
            unet_cfg=unet_cfg, vae_cfg=vae_cfg, clip_cfg=clip_cfg, policy=policy,
            unet=unet, vae=vae, text_encoder=TextEncoder(clip, tokenizer),
            schedule=DiffusionSchedule.linear_sd(unet_cfg.num_timesteps), device=dev,
        )

    @classmethod
    def random_init(
        cls,
        unet_cfg: ModelScopeUNetConfig | None = None,
        policy: Policy = Policy(),
        seed: int = 0,
        device: torch.device | str = "cuda",
    ) -> "ModelScopePipeline":
        """Random-weight pipeline (tests and smoke runs; no checkpoint on
        disk needed). The tokenizer is ``CLIPTokenizer.for_tests()``."""
        tokenizer = CLIPTokenizer.for_tests()
        unet_cfg, vae_cfg, clip_cfg = cls.configs(unet_cfg, tokenizer)

        def fill(unet, vae, clip):
            init_weights(unet, seed, _ZERO_INIT)
            init_weights(vae, seed + 1)
            init_weights(clip, seed + 2)

        return cls._build(unet_cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    @classmethod
    def from_jax(
        cls, unet_params, vae_params, clip_params, unet_cfg: ModelScopeUNetConfig,
        policy: Policy = Policy(), device: torch.device | str = "cuda",
    ) -> "ModelScopePipeline":
        """Pipeline on the JAX package's parameter trees (numpy leaves) of a
        ``random_init`` pipeline with this UNet config."""
        tokenizer = CLIPTokenizer.for_tests()
        unet_cfg, vae_cfg, clip_cfg = cls.configs(unet_cfg, tokenizer)

        def fill(unet, vae, clip):
            convert.load_into(unet, convert.from_jax_unet(unet_params, unet_cfg))
            convert.load_into(vae, convert.from_jax_vae(vae_params, vae_cfg))
            convert.load_into(clip, convert.from_jax_clip(clip_params, clip_cfg))

        return cls._build(unet_cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    # ------------------------------------------------------------------

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(F, h, w, 4) scaled latents -> (F, H, W, 3) uint8 RGB."""
        return decode_latents(self.vae, self.vae_cfg, latents, SCALE_FACTOR)

    def infer(
        self,
        args: T2VArgs,
        *,
        batch_index: int = 0,
        noise: torch.Tensor | None = None,
    ) -> InferResult:
        """Answer one request on the default (non-windowed) DDIM_Gaussian
        txt2vid path. ``noise`` replaces the seeded starting latent (tests
        hand both packages the same numpy noise)."""
        sanity_check_args(args)
        seed = rng_lib.resolve_seed(args.seed)
        batch_seed = rng_lib.batch_seed(seed, batch_index) if args.seed != -1 else seed
        ss = _spatial_scale(self.vae_cfg)
        shape = (1, args.frames, args.height // ss, args.width // ss, 4)
        dev = self.device

        t0 = time.perf_counter()
        self.text_encoder.comma_backtrack = args.comma_padding_backtrack
        self.text_encoder.enable_emphasis = args.enable_emphasis
        conditioning = self.text_encoder.encode_request(args.prompt, args.n_prompt, args.steps)
        _sync(dev)
        t_text = time.perf_counter() - t0

        t0 = time.perf_counter()
        gen = rng_lib.generator(batch_seed, dev)
        if noise is None:
            noise = rng_lib.latent_noise(gen, shape, dev)
        unet = self.unet
        x0 = sample_loop(
            lambda x, t, ctx: unet(x, t, ctx), self.schedule, steps=args.steps, shape=shape,
            cond=conditioning.cond, uncond=conditioning.uncond,
            guidance_scale=args.cfg_scale, eta=args.eta, sampler_name=args.sampler,
            generator=gen, noise=noise.to(dev), device=dev,
            parameterization=self.unet_cfg.parameterization,
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
        """Generation-parameter provenance string."""
        return (
            f"{args.prompt}\n"
            f"Negative prompt: {args.n_prompt}\n"
            f"Steps: {args.steps}, Sampler: {args.sampler}, "
            f"CFG scale: {args.cfg_scale}, Seed: {seed}, "
            f"Size: {args.width}x{args.height}, Frames: {args.frames}, "
            f"Model: {args.model or 'ModelScope'}"
        )
