"""End-to-end ModelScope text2video pipeline of the port.

The PyTorch counterpart of the JAX package's ``pipeline/pipeline.py``: text
encode -> fused-CFG step loop of any registered sampler -> frame-batched
VAE decode -> uint8 RGB frames. ``infer`` also answers vid2vid (source
latents from ``compute_latents``, re-noised to the strength), img2vid
inpainting (``build_inpainting_inputs``: keyframed mask weights, masked
start, optional per-step blend), DeepCache requests, and windowed requests
whose callback runs between steps and may raise to interrupt or skip.
Everything runs on one device, the card unless the caller asks for the
CPU. Seed policy: the request's seed, ``-1`` resolved to a fresh one,
``seed + batch_index`` per batch.

``random_init`` builds seeded random weights (no checkpoint needed) with
the JAX package's zero-initialised leaves; ``from_jax`` loads the JAX
package's parameter trees through ``io/convert.py``; ``from_model_dir``
loads a published ModelScope directory (``configuration.json``, the three
torch checkpoints and the BPE vocab) or a directory the trainer saved
(``from_native``); ``load_pipeline`` caches one loaded pipeline and
switches to another directory on demand. ``release_aux`` / ``reload_aux``
drop and re-read the VAE and text tower between requests ("Main Model
Only"); ``apply_stable_lora`` merges a stable-lora file into the UNet and
the text tower.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from t2v_torch.core import rng as rng_lib
from t2v_torch.core.config import (
    CLIPTextConfig,
    ModelScopeUNetConfig,
    T2VArgs,
    VAEConfig,
    config_from_dict,
    sanity_check_args,
)
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion import deepcache as deepcache_mod
from t2v_torch.diffusion.sampling import sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.io import convert, train_state
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.models.vae import AutoencoderKL, decode_uint8, encode_latents
from t2v_torch.pipeline.keyframes import KeyFrameSeries
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.encoder import TextEncoder
from t2v_torch.text.tokenizer import CLIPTokenizer

SCALE_FACTOR = 0.18215  # latent scaling
DECODE_CHUNK = 8  # frames per VAE encode call (bounds the encoder's activation memory)
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


def compute_latents(vae: AutoencoderKL, frames_rgb, scale_factor: float,
                    device: torch.device) -> torch.Tensor:
    """(F, H, W, 3) float frames in [-1, 1] (numpy or tensor) -> (1, F, h, w, 4)
    scaled latents in float32: the deterministic posterior mean x
    ``scale_factor``, encoded ``DECODE_CHUNK`` frames at a time."""
    x = torch.as_tensor(np.asarray(frames_rgb, np.float32) if not torch.is_tensor(frames_rgb)
                        else frames_rgb.float()).to(device)
    chunks = [encode_latents(vae, x[i : i + DECODE_CHUNK], scale_factor)
              for i in range(0, x.shape[0], DECODE_CHUNK)]
    return torch.cat(chunks, dim=0)[None]


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


def _checkpoint_names(model_dir: str) -> dict[str, str]:
    """The checkpoint file names ``configuration.json`` gives (or the
    published defaults)."""
    with open(os.path.join(model_dir, "configuration.json")) as f:
        model_args = json.load(f)["model"].get("model_args", {})
    return {
        "unet": model_args.get("ckpt_unet", "text2video_pytorch_model.pth"),
        "vae": model_args.get("ckpt_autoencoder", "VQGAN_autoencoder.pth"),
        "clip": model_args.get("ckpt_clip", "open_clip_pytorch_model.bin"),
    }


def _load_module(build: Callable[[], nn.Module], sd, policy: Policy, device) -> nn.Module:
    """``build()`` on the meta device (no memory, no init), then the state
    dict's tensors cast to the policy's dtype on ``device``."""
    with torch.device("meta"):
        module = build()
    return convert.load_state(module, sd, dtype=policy.param_dtype, device=device).eval()


@dataclass
class ModelScopePipeline:
    unet_cfg: ModelScopeUNetConfig
    vae_cfg: VAEConfig
    clip_cfg: CLIPTextConfig
    policy: Policy
    unet: UNetSD
    vae: AutoencoderKL | None  # None after release_aux
    text_encoder: TextEncoder | None  # None after release_aux
    schedule: DiffusionSchedule
    device: torch.device
    model_dir: str | None = None  # where reload_aux re-reads the VAE and text tower

    @staticmethod
    def configs(unet_cfg: ModelScopeUNetConfig | None, tokenizer: CLIPTokenizer,
                vae_cfg: VAEConfig | None = None, clip_cfg: CLIPTextConfig | None = None):
        """(unet, vae, clip) configs of a random-weight pipeline, chosen as
        the JAX package's ``random_init`` chooses them: the tiny VAE and
        text tower beside a tiny UNet, the full ones beside a full UNet.
        A ``vae_cfg`` or ``clip_cfg`` given is taken as it is."""
        unet_cfg = unet_cfg or ModelScopeUNetConfig().tiny()
        small = unet_cfg.dim < 128
        if vae_cfg is None:
            vae_cfg = VAEConfig().tiny() if small else VAEConfig()
        if clip_cfg is None:
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
        *,
        vae_cfg: VAEConfig | None = None,
        clip_cfg: CLIPTextConfig | None = None,
    ) -> "ModelScopePipeline":
        """Random-weight pipeline (tests and smoke runs; no checkpoint on
        disk needed). The tokenizer is ``CLIPTokenizer.for_tests()``."""
        tokenizer = CLIPTokenizer.for_tests()
        unet_cfg, vae_cfg, clip_cfg = cls.configs(unet_cfg, tokenizer, vae_cfg, clip_cfg)

        def fill(unet, vae, clip):
            init_weights(unet, seed, _ZERO_INIT)
            init_weights(vae, seed + 1)
            init_weights(clip, seed + 2)

        return cls._build(unet_cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    @classmethod
    def from_jax(
        cls, unet_params, vae_params, clip_params, unet_cfg: ModelScopeUNetConfig,
        policy: Policy = Policy(), device: torch.device | str = "cuda", *,
        vae_cfg: VAEConfig | None = None, clip_cfg: CLIPTextConfig | None = None,
    ) -> "ModelScopePipeline":
        """Pipeline on the JAX package's parameter trees (numpy leaves) of a
        ``random_init`` pipeline with this UNet config (or of one with the
        VAE and text-tower configs given)."""
        tokenizer = CLIPTokenizer.for_tests()
        unet_cfg, vae_cfg, clip_cfg = cls.configs(unet_cfg, tokenizer, vae_cfg, clip_cfg)

        def fill(unet, vae, clip):
            convert.load_into(unet, convert.from_jax_unet(unet_params, unet_cfg))
            convert.load_into(vae, convert.from_jax_vae(vae_params, vae_cfg))
            convert.load_into(clip, convert.from_jax_clip(clip_params, clip_cfg))

        return cls._build(unet_cfg, vae_cfg, clip_cfg, tokenizer, policy, device, fill)

    @classmethod
    def from_model_dir(
        cls,
        model_dir: str,
        policy: Policy = Policy.bf16(),
        *,
        vae_cfg: VAEConfig | None = None,
        clip_cfg: CLIPTextConfig | None = None,
        device: torch.device | str = "cuda",
    ) -> "ModelScopePipeline":
        """Load a published ModelScope directory: ``configuration.json``
        (the UNet config and the ``ckpt_*`` file names),
        ``text2video_pytorch_model.pth``, ``VQGAN_autoencoder.pth``,
        ``open_clip_pytorch_model.bin`` and ``bpe_simple_vocab_16e6.txt.gz``
        (in the directory or its parent); or a directory the trainer saved,
        detected by its ``t2v_torch.json``. ``vae_cfg`` / ``clip_cfg``
        default to the published SD VAE and ViT-H-14 text tower; overrides
        serve reduced-scale checkpoints."""
        if train_state.is_native_checkpoint(model_dir):
            return cls.from_native(model_dir, policy, device=device)
        dev = resolve_device(device)
        unet_cfg = ModelScopeUNetConfig.from_configuration_json(model_dir)
        path = os.path.join(model_dir, _checkpoint_names(model_dir)["unet"])
        unet = _load_module(lambda: UNetSD(unet_cfg), convert.load_torch_checkpoint(path),
                            policy, dev)
        pipe = cls(
            unet_cfg=unet_cfg, vae_cfg=vae_cfg or VAEConfig(),
            clip_cfg=clip_cfg or CLIPTextConfig.vit_h_14(), policy=policy, unet=unet,
            vae=None, text_encoder=None,
            schedule=DiffusionSchedule.linear_sd(unet_cfg.num_timesteps), device=dev,
            model_dir=model_dir,
        )
        pipe.reload_aux()
        return pipe

    @classmethod
    def from_native(
        cls, model_dir: str, policy: Policy = Policy.bf16(), *,
        device: torch.device | str = "cuda",
    ) -> "ModelScopePipeline":
        """Load what ``io/train_state.save_weights`` wrote: the three
        configs from ``t2v_torch.json``, the weights from
        ``{unet,vae,clip}.safetensors``, the vocab shipped beside them."""
        dev = resolve_device(device)
        meta, sds = train_state.load_weights(model_dir, only=("unet",))
        if meta.get("model_family", "modelscope") != "modelscope":
            raise ValueError(f"{model_dir} holds a {meta['model_family']} checkpoint, which "
                             "ModelScopePipeline does not load")
        unet_cfg = config_from_dict(ModelScopeUNetConfig, meta["unet_cfg"])
        unet = _load_module(lambda: UNetSD(unet_cfg), sds["unet"], policy, dev)
        pipe = cls(
            unet_cfg=unet_cfg, vae_cfg=config_from_dict(VAEConfig, meta["vae_cfg"]),
            clip_cfg=config_from_dict(CLIPTextConfig, meta["clip_cfg"]), policy=policy,
            unet=unet, vae=None, text_encoder=None,
            schedule=DiffusionSchedule.linear_sd(unet_cfg.num_timesteps), device=dev,
            model_dir=model_dir,
        )
        pipe.reload_aux()
        return pipe

    # ------------------------------------------------------------------
    # 'Main Model Only' retention: keep the UNet, drop the VAE and the text
    # tower between requests and read them again from the model dir

    def release_aux(self) -> None:
        """Drop the VAE and the text tower; on the card the caching
        allocator returns their memory to the device. ``reload_aux``
        restores them."""
        self.vae = None
        self.text_encoder = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reload_aux(self) -> None:
        """Read the VAE, the text tower and the tokenizer from the model
        dir; a no-op while both are resident."""
        if self.vae is not None and self.text_encoder is not None:
            return
        if self.model_dir is None:
            raise ValueError(
                "cannot reload VAE/CLIP: pipeline has no model_dir "
                "(random-init pipelines cannot use 'Main Model Only')"
            )
        if train_state.is_native_checkpoint(self.model_dir):
            _, sds = train_state.load_weights(self.model_dir, only=("vae", "clip"))
            sd_vae, sd_clip = sds["vae"], sds["clip"]
        else:
            names = _checkpoint_names(self.model_dir)
            sd_vae = convert.strip_first_stage_prefix(
                convert.load_torch_checkpoint(os.path.join(self.model_dir, names["vae"])))
            sd_clip = convert.load_torch_checkpoint(os.path.join(self.model_dir, names["clip"]))
        self.vae = _load_module(lambda: AutoencoderKL(self.vae_cfg), sd_vae, self.policy,
                                self.device)
        clip = _load_module(lambda: CLIPTextTransformer(self.clip_cfg), sd_clip, self.policy,
                            self.device)
        tokenizer = CLIPTokenizer.find_and_load(self.model_dir,
                                                os.path.dirname(os.path.abspath(self.model_dir)))
        self.text_encoder = TextEncoder(clip, tokenizer)

    # ------------------------------------------------------------------

    def apply_stable_lora(self, lora_sd, alpha: float = 1.0, *,
                          undo: bool = False) -> dict[str, list[str]]:
        """Merge a stable-lora state dict (numpy, as read from its file)
        into the UNet and the text tower in place, as the reference merges
        into both; ``undo=True`` reverses a merge of the same file and
        alpha. Returns {"unet": skipped, "clip": skipped} module names."""
        from t2v_torch.pipeline.lora import text_module_index, unet_module_index

        skipped = {"unet": _merge_lora(self.unet, lora_sd, alpha,
                                       unet_module_index(self.unet_cfg), undo), "clip": []}
        if self.text_encoder is not None:
            skipped["clip"] = _merge_lora(self.text_encoder.model, lora_sd, alpha,
                                          text_module_index(self.clip_cfg), undo)
            self.text_encoder.invalidate_cache()
        return skipped

    # ------------------------------------------------------------------

    def compute_latents(self, frames_rgb) -> torch.Tensor:
        """(F, H, W, 3) float in [-1, 1] -> (1, F, h, w, 4) scaled latents."""
        return compute_latents(self.vae, frames_rgb, SCALE_FACTOR, self.device)

    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(F, h, w, 4) scaled latents -> (F, H, W, 3) uint8 RGB."""
        return decode_latents(self.vae, self.vae_cfg, latents, SCALE_FACTOR)

    def build_inpainting_inputs(
        self,
        image_rgb: np.ndarray,
        args: T2VArgs,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """img2vid: (masked_latents, mask, image_latents), each (1, F, h, w, 4)
        float32. The source image (H, W, 3 uint8) is encoded once per frame;
        frame i's mask weight comes from the keyframe string
        ``args.inpainting_weights``; the start is source * (1 - mask) + noise
        * mask. ``noise`` is drawn from ``generator`` (by default one seeded
        with the request's seed) when not given; ``image_latents`` feed the
        progressive per-step blend."""
        ss = _spatial_scale(self.vae_cfg)
        lat_h, lat_w = args.height // ss, args.width // ss
        keys = KeyFrameSeries(args.frames, args.seed, max(args.inpainting_frames, 1))
        weights = keys.inpainting_weights(args.inpainting_weights)

        img = np.asarray(image_rgb, np.float32) / 255.0 * 2.0 - 1.0
        image_latents = self.compute_latents(np.repeat(img[None], args.frames, axis=0))
        mask = torch.from_numpy(
            np.broadcast_to(weights.reshape(1, -1, 1, 1, 1), (1, args.frames, lat_h, lat_w, 4))
            .astype(np.float32)).to(self.device)
        if noise is None:
            if generator is None:
                generator = rng_lib.generator(rng_lib.resolve_seed(args.seed), self.device)
            noise = torch.randn(mask.shape, generator=generator, device=self.device)
        masked = image_latents * (1 - mask) + noise.to(self.device) * mask
        return masked, mask, image_latents

    def infer(
        self,
        args: T2VArgs,
        *,
        latents: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        image_latents: torch.Tensor | None = None,
        skip_steps: int = 0,
        is_vid2vid: bool = False,
        callback: Callable[[int], None] | None = None,
        callback_interval: int | None = None,
        batch_index: int = 0,
        inpaint_mode: str = "initial_only",
        deep_cache_interval: int = 1,
        noise: torch.Tensor | None = None,
        step_noise=None,
        inpaint_noise=None,
    ) -> InferResult:
        """Answer one request with ``args.sampler`` over ``args.steps -
        skip_steps`` steps. ``latents`` with ``is_vid2vid`` is a vid2vid
        source (re-noised to ``args.strength``); ``latents`` without it a
        masked start, which with ``mask`` and ``image_latents`` and an
        ``inpaint_mode`` of 'progressive' or 'lvdm_static' is blended every
        step. ``deep_cache_interval`` > 1 runs DeepCache on a txt2vid request
        of a single-state sampler (others run exact). ``callback(done)`` runs
        after every ``callback_interval`` steps and after the last; an
        exception it raises (``core.state.InterruptedException``) stops the
        request. ``noise``, ``step_noise[i]`` and ``inpaint_noise[i]`` replace
        the seeded draws (tests hand both packages the same numpy noise)."""
        sanity_check_args(args)
        seed = rng_lib.resolve_seed(args.seed)
        batch_seed = rng_lib.batch_seed(seed, batch_index) if args.seed != -1 else seed
        steps = args.steps - skip_steps
        ss = _spatial_scale(self.vae_cfg)
        shape = (1, args.frames, args.height // ss, args.width // ss, 4)
        dev = self.device

        if self.text_encoder is None or self.vae is None:
            raise ValueError("the VAE and text tower were released (release_aux); "
                             "call reload_aux() before infer()")
        t0 = time.perf_counter()
        self.text_encoder.comma_backtrack = args.comma_padding_backtrack
        self.text_encoder.enable_emphasis = args.enable_emphasis
        conditioning = self.text_encoder.encode_request(args.prompt, args.n_prompt, steps)
        _sync(dev)
        t_text = time.perf_counter() - t0

        t0 = time.perf_counter()
        gen = rng_lib.generator(batch_seed, dev)
        if noise is None:
            noise = rng_lib.latent_noise(gen, shape, dev)
        on_dev = lambda t: None if t is None else t.to(device=dev, dtype=torch.float32)
        unet = self.unet
        common = dict(
            steps=steps, shape=shape, cond=conditioning.cond, uncond=conditioning.uncond,
            guidance_scale=args.cfg_scale, eta=args.eta, sampler_name=args.sampler,
            generator=gen, noise=noise.to(dev), step_noise=step_noise,
            parameterization=self.unet_cfg.parameterization, callback=callback,
            callback_interval=callback_interval, device=dev,
        )
        if (deep_cache_interval > 1 and latents is None and mask is None
                and args.sampler in deepcache_mod.SAMPLERS):
            x0 = deepcache_mod.sample_loop_deepcache(
                lambda x, t, ctx: unet(x, t, ctx, return_deep=True),
                lambda x, t, ctx, feat: unet(x, t, ctx, deep_feature=feat),
                self.schedule, interval=deep_cache_interval, **common)
        else:
            x0 = sample_loop(
                lambda x, t, ctx: unet(x, t, ctx), self.schedule, latents=on_dev(latents),
                is_vid2vid=is_vid2vid, strength=args.strength, mask=on_dev(mask),
                image_latents=on_dev(image_latents), inpaint_mode=inpaint_mode,
                inpaint_noise=inpaint_noise, **common)
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


@torch.no_grad()
def _merge_lora(module: nn.Module, lora_sd, alpha: float, index, undo: bool) -> list[str]:
    """``merge_stable_lora`` into ``module``'s own tensors; returns the
    skipped module names."""
    from t2v_torch.pipeline.lora import merge_stable_lora

    params = module.state_dict()
    merged, skipped = merge_stable_lora(params, lora_sd, alpha, index, undo=undo)
    for name, t in merged.items():
        if t is not params[name]:
            params[name].copy_(t)
    return skipped


_PIPELINE_CACHE: dict[tuple, ModelScopePipeline] = {}


def load_pipeline(model_dir: str, policy: Policy = Policy.bf16(), keep_in_vram: bool = True,
                  device: torch.device | str = "cuda") -> ModelScopePipeline:
    """Cached loader with model hot-switch semantics: a directory other
    than the cached one drops the cached pipeline before loading the new
    one, so two never hold the card at once. ``keep_in_vram=False`` skips
    caching: the pipeline lives only for the caller's run."""
    key = (os.path.abspath(model_dir), policy.param_dtype, str(torch.device(device)))
    if key in _PIPELINE_CACHE:
        return _PIPELINE_CACHE[key]
    _PIPELINE_CACHE.clear()
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.empty_cache()
    pipe = ModelScopePipeline.from_model_dir(model_dir, policy, device=device)
    if keep_in_vram:
        _PIPELINE_CACHE[key] = pipe
    return pipe
