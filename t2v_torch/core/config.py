"""Configuration schema of the PyTorch port.

The port's own copy of the JAX package's ``core/config.py``: the model
architectures (ModelScope UNet, VideoCrafter UNet, SD KL-VAE, CLIP text
towers) and the generation request with its reference defaults (the JAX
package keeps the VideoCrafter config beside its UNet, in
``models/videocrafter_unet.py``). Field names, defaults and
``tiny()`` miniatures are the same, so one request or config means the same
thing to both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelScopeUNetConfig:
    """Architecture of the ModelScope 3D-factorised UNet (``UNetSD``);
    defaults are the published ModelScope 1.7B text2video values."""

    in_dim: int = 4
    dim: int = 320
    y_dim: int = 768
    context_dim: int = 1024
    out_dim: int = 4
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    head_dim: int = 64
    num_res_blocks: int = 2
    attn_scales: tuple[float, ...] = (1.0, 0.5, 0.25)
    dropout: float = 0.1
    temporal_attention: bool = True
    temporal_attn_times: int = 1
    use_scale_shift_norm: bool = False
    parameterization: str = "eps"  # "eps" | "x0" | "v"
    num_timesteps: int = 1000

    @property
    def embed_dim(self) -> int:
        return self.dim * 4

    @classmethod
    def from_configuration_json(cls, model_dir: str) -> "ModelScopeUNetConfig":
        """Parse a ModelScope ``configuration.json``.

        The reference stores ``temporal_attention`` as the *string* "True";
        we preserve that quirk when parsing.
        """
        with open(os.path.join(model_dir, "configuration.json")) as f:
            config_dict = json.load(f)
        cfg = config_dict["model"]["model_cfg"]
        ta = cfg.get("temporal_attention", True)
        if isinstance(ta, str):
            ta = ta == "True"
        return cls(
            in_dim=cfg["unet_in_dim"],
            dim=cfg["unet_dim"],
            y_dim=cfg["unet_y_dim"],
            context_dim=cfg["unet_context_dim"],
            out_dim=cfg["unet_out_dim"],
            dim_mult=tuple(cfg["unet_dim_mult"]),
            num_heads=cfg["unet_num_heads"],
            head_dim=cfg["unet_head_dim"],
            num_res_blocks=cfg["unet_res_blocks"],
            attn_scales=tuple(cfg["unet_attn_scales"]),
            dropout=cfg["unet_dropout"],
            parameterization=cfg.get("mean_type", "eps"),
            temporal_attention=ta,
            num_timesteps=cfg.get("num_timesteps", 1000),
        )

    def tiny(self) -> "ModelScopeUNetConfig":
        """A CPU-testable miniature with the same topology."""
        return dataclasses.replace(
            self,
            dim=32,
            context_dim=32,
            y_dim=32,
            num_heads=2,
            head_dim=16,
            num_res_blocks=1,
            dim_mult=(1, 2),
            attn_scales=(1.0, 0.5),
        )


@dataclass(frozen=True)
class VideoCrafterUNetConfig:
    """Architecture of the VideoCrafter (LVDM) 3D UNet; defaults are the
    base text2video model's (8 heads at every level, so 40-, 80- and
    160-wide heads; relative-position temporal attention over 16 frames)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (1, 2, 4)
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    kernel_size_t: int = 1
    padding_t: int = 0
    temporal_length: int = 16
    use_relative_position: bool = True
    num_classes: int | None = None  # class-conditional label embedding (adm)
    conditioning_key: str = "crossattn"
    cond_stage2_key: str | None = None  # "temporal_context": FPS-conditioned
    parameterization: str = "eps"  # "eps" | "x0" | "v"
    num_timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    scale_factor: float = 0.18215

    def tiny(self) -> "VideoCrafterUNetConfig":
        """A CPU-testable miniature with the same topology."""
        return dataclasses.replace(
            self,
            model_channels=32,
            context_dim=32,
            num_heads=2,
            num_res_blocks=1,
            channel_mult=(1, 2),
            attention_resolutions=(1,),
            temporal_length=4,
        )


@dataclass(frozen=True)
class VAEConfig:
    """SD KL-VAE (``VQGAN_autoencoder.pth``) architecture."""

    z_channels: int = 4
    embed_dim: int = 4
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = ()
    resolution: int = 256
    double_z: bool = True
    scale_factor: float = 0.18215

    def tiny(self) -> "VAEConfig":
        # ch must stay a multiple of 32 (GroupNorm groups)
        return dataclasses.replace(self, ch=32, ch_mult=(1, 2), num_res_blocks=1)


@dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP text tower; defaults are ViT-H-14 (width 1024, 24 layers,
    16 heads, penultimate layer output)."""

    vocab_size: int = 49408
    width: int = 1024
    layers: int = 24
    heads: int = 16
    context_length: int = 77
    layer: str = "penultimate"  # "last" | "penultimate"
    final_ln: bool = True
    act: str = "gelu"  # "gelu" | "quick_gelu"

    @classmethod
    def vit_h_14(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def clip_l_14(cls) -> "CLIPTextConfig":
        """The VideoCrafter text tower: CLIP-L, last hidden state, quick-GELU."""
        return cls(width=768, layers=12, heads=12, layer="last", act="quick_gelu")

    def tiny(self) -> "CLIPTextConfig":
        return dataclasses.replace(self, width=64, layers=2, heads=2, vocab_size=1024)


SAMPLER_NAMES: tuple[str, ...] = (
    "DDIM_Gaussian", "DDIM", "UniPC", "DPM++ 2M", "DPM++ 2M Karras",
    "Euler", "Euler a",
)


@dataclass
class T2VArgs:
    """Generation request with the reference's defaults."""

    prompt: str = ""
    n_prompt: str = "text, watermark, copyright, blurry, nsfw"
    sampler: str = "DDIM_Gaussian"
    steps: int = 30
    frames: int = 24
    seed: int = -1
    cfg_scale: float = 17.0
    width: int = 256
    height: int = 256
    eta: float = 0.0
    batch_count: int = 1
    do_vid2vid: bool = False
    vid2vid_input: str | None = None
    strength: float = 0.75
    vid2vid_startFrame: int = 0
    inpainting_image: str | None = None
    inpainting_frames: int = 0
    inpainting_weights: str = '0:(t/max_i_f), "max_i_f":(1)'
    cond_fps: int | None = None
    comma_padding_backtrack: int = 20
    enable_emphasis: bool = True
    model_type: str = "ModelScope"
    model: str | None = "<modelscope>"

    def replace(self, **kw: Any) -> "T2VArgs":
        return dataclasses.replace(self, **kw)


@dataclass
class T2VOutputArgs:
    """Video output options, with the reference's defaults."""

    skip_video_creation: bool = False
    fps: int = 15
    make_gif: bool = False  # write an animated GIF alongside the mp4
    delete_imgs: bool = False  # delete PNG frames after a successful stitch
    # output path templates; None = the default per-run directory layout.
    # image_path may carry a %-style frame index.
    image_path: str | None = None
    mp4_path: str | None = None
    ffmpeg_location: str | None = None  # auto-discovered when None
    ffmpeg_crf: int = 17
    ffmpeg_preset: str = "slow"
    add_soundtrack: str = "None"  # "None" | "File" | "Init Video"
    soundtrack_path: str = ""
    # schema-only, as in the reference: no code path reads them
    render_steps: bool = False
    path_name_modifier: str = "x0_pred"  # "x0_pred" | "x"
    # upscaling / frame interpolation (media/postprocess.py)
    r_upscale_video: bool = False
    r_upscale_factor: str = "x2"  # "x2" | "x3" | "x4"
    r_upscale_model: str = "realesr-animevideov3"
    r_upscale_keep_imgs: bool = True
    frame_interpolation_engine: str = "None"  # "None" | "RIFE v4.6" | "FILM"
    frame_interpolation_x_amount: int = 2
    frame_interpolation_slow_mo_enabled: bool = False
    frame_interpolation_slow_mo_amount: int = 2
    frame_interpolation_keep_imgs: bool = False

    def replace(self, **kw: Any) -> "T2VOutputArgs":
        return dataclasses.replace(self, **kw)


def config_from_dict(cls, d: dict) -> Any:
    """Rebuild a config dataclass from its JSON dict (lists -> tuples,
    unknown keys ignored so old checkpoints survive config growth)."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def sanity_check_args(args: T2VArgs) -> None:
    """Validate a request (the reference's ``T2VArgs_sanity_check``)."""
    if args.frames < 1:
        raise ValueError("Frames count cannot be lower than 1!")
    if args.batch_count < 1:
        raise ValueError("Batch count cannot be lower than 1!")
    if args.width < 1 or args.height < 1:
        raise ValueError("Video dimensions cannot be lower than 1 pixel!")
    if args.cfg_scale < 1:
        raise ValueError("CFG scale cannot be lower than 1!")
    if args.steps < 1:
        raise ValueError("Steps cannot be lower than 1!")
    if not 0 <= args.strength <= 1:
        raise ValueError("vid2vid strength should be in range of 0 to 1!")
    if args.vid2vid_startFrame >= args.frames:
        raise ValueError("vid2vid start frame cannot be greater than the number of frames!")
    if not 0 <= args.inpainting_frames <= args.frames:
        raise ValueError("inpainting frames count should lie between 0 and the frames number!")
    if args.sampler not in SAMPLER_NAMES:
        raise ValueError("Sampler does not exist.")
