"""Host-side video post-processing: upscaling and frame interpolation.

The reference carries these options in its arg schema (reference
scripts/t2v_helpers/args.py:277-290, inherited from Deforum's output
args) but the text2video extension never acts on them — they are
schema-only stubs. Here they are functional, with classical
implementations that need no external model weights (the Deforum
counterparts shell out to RealESRGAN / RIFE / FILM checkpoints, which
cannot be assumed present):

  * upscale: per-frame Lanczos (or bicubic) resampling for the x2/x3/x4
    factors. ``r_upscale_model`` keeps its reference values; any value is
    accepted and selects only the resampling flavor, so model-based
    upscalers can be slotted in behind the same interface later.
  * frame interpolation: bidirectional Farneback optical flow with
    symmetric backward warping — inserts ``x_amount - 1`` in-between
    frames between every consecutive pair.

All functions take/return lists of RGB uint8 ``(H, W, 3)`` numpy frames,
the same frame format the pipelines emit. The port's copy of the JAX
package's ``media/postprocess.py``.
"""

from __future__ import annotations

import numpy as np

_FACTORS = {"x2": 2, "x3": 3, "x4": 4}


def _factor_to_int(factor) -> int:
    if isinstance(factor, str):
        try:
            return _FACTORS[factor]
        except KeyError:
            raise ValueError(
                f"upscale factor {factor!r} not in {sorted(_FACTORS)}"
            ) from None
    f = int(factor)
    if f < 1:
        raise ValueError(f"upscale factor must be >= 1, got {f}")
    return f


def upscale_frames(frames, factor="x2", model: str = "realesr-animevideov3"):
    """Resample every frame by ``factor`` (reference r_upscale_factor
    values "x2"|"x3"|"x4", args.py:279). ``model`` keeps the reference's
    r_upscale_model field; "bicubic" selects bicubic, everything else
    (including the RealESRGAN model names) uses Lanczos4."""
    import cv2

    f = _factor_to_int(factor)
    if f == 1:
        return list(frames)
    interp = cv2.INTER_CUBIC if model == "bicubic" else cv2.INTER_LANCZOS4
    out = []
    for frame in frames:
        h, w = frame.shape[:2]
        out.append(cv2.resize(frame, (w * f, h * f), interpolation=interp))
    return out


def _flow(gray_a, gray_b):
    import cv2

    return cv2.calcOpticalFlowFarneback(
        gray_a, gray_b, None,
        pyr_scale=0.5, levels=3, winsize=21, iterations=3,
        poly_n=5, poly_sigma=1.2, flags=0,
    )


def _warp(frame, flow, scale):
    """Backward-warp ``frame`` along ``scale * flow`` (first-order
    approximation: the flow field is read at the destination pixel)."""
    import cv2

    h, w = frame.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    mapx = gx - scale * flow[..., 0]
    mapy = gy - scale * flow[..., 1]
    return cv2.remap(
        frame, mapx, mapy, interpolation=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_REPLICATE,
    )


def interpolate_frames(frames, x_amount: int = 2):
    """Insert ``x_amount - 1`` optical-flow in-betweens between every
    consecutive frame pair; output length is (N-1)*x_amount + 1.

    Bidirectional: each in-between at fraction t blends a forward warp of
    the left frame (along t·flow_ab) with a backward warp of the right
    frame (along (1-t)·flow_ba), weighted (1-t, t).
    """
    import cv2

    x_amount = int(x_amount)
    if x_amount < 1:
        raise ValueError(f"x_amount must be >= 1, got {x_amount}")
    frames = list(frames)
    if x_amount == 1 or len(frames) < 2:
        return frames

    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    out = []
    for i in range(len(frames) - 1):
        a, b = frames[i], frames[i + 1]
        flow_ab = _flow(grays[i], grays[i + 1])
        flow_ba = _flow(grays[i + 1], grays[i])
        out.append(a)
        for j in range(1, x_amount):
            t = j / x_amount
            # a(p) lands at p + t*flow_ab(p) by time t → mid(q) ≈ a(q - t*flow_ab)
            wa = _warp(a, flow_ab, t).astype(np.float32)
            wb = _warp(b, flow_ba, 1.0 - t).astype(np.float32)
            mid = (1.0 - t) * wa + t * wb
            out.append(np.clip(mid, 0, 255).astype(np.uint8))
    out.append(frames[-1])
    return out


def postprocess_frames(frames, out_args):
    """Apply the T2VOutputArgs upscale / frame-interpolation options.

    Returns (frames, fps): interpolation multiplies the playback fps by
    x_amount so wall-clock duration is preserved; slow-mo mode divides it
    back by slow_mo_amount (Deforum fps semantics for these fields).
    """
    fps = float(out_args.fps)
    if (out_args.frame_interpolation_engine or "None") != "None":
        x = int(out_args.frame_interpolation_x_amount)
        frames = interpolate_frames(frames, x)
        fps *= x
        if out_args.frame_interpolation_slow_mo_enabled:
            fps /= max(int(out_args.frame_interpolation_slow_mo_amount), 1)
    if out_args.r_upscale_video:
        frames = upscale_frames(
            frames, out_args.r_upscale_factor, out_args.r_upscale_model
        )
    return frames, fps
