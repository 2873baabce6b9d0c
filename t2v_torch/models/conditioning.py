"""Conditioning-key router for the LVDM model family (the port of the JAX
package's ``models/conditioning.py``).

Pure-function equivalent of the reference's ``DiffusionWrapper.forward``
dispatch (ddpm3d.py:1362-1433), which routes a conditioning dict into the
UNet by ``conditioning_key``:

  * ``c_concat``      — concatenated to the latent's channel axis;
  * ``c_crossattn``   — cross-attention context (concatenated along tokens);
  * ``adm`` variants  — a class/embedding vector ``y`` fed to the UNet's
                        label embedding;
  * ``time`` variants — an ``s`` signal (fps etc.). The reference's 3D
                        ``UNetModel.forward`` has no ``s`` parameter — it is
                        swallowed by ``**kwargs`` (openaimodel3d.py:632) —
                        so for parity we accept and ignore it; same for the
                        ``mask`` of the ``*-mask`` keys.

Returns ``(x, unet_kwargs)`` ready for ``VideoCrafterUNet.forward``. The x
layout is (B, T, H, W, C) — channel-last, so concat targets axis -1.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

CONDITIONING_KEYS = (
    None,
    "concat",
    "crossattn",
    "hybrid",
    "resblockcond",
    "adm",
    "hybrid-adm",
    "hybrid-time",
    "concat-time-mask",
    "concat-adm-mask",
    "crossattn-adm",
    "hybrid-adm-mask",
    "hybrid-time-adm",
)


def _cat_concat(x, c_concat):
    return torch.cat([x] + list(c_concat), dim=-1)


def _cat_crossattn(c_crossattn):
    return torch.cat(list(c_crossattn), dim=1)


def route_conditioning(
    conditioning_key: str | None,
    x: torch.Tensor,
    cond: Mapping[str, Any],
) -> tuple[torch.Tensor, dict]:
    """cond keys: c_concat (list), c_crossattn (list), c_adm, s, mask."""
    k = conditioning_key
    cc_list = cond.get("c_concat")
    ca_list = cond.get("c_crossattn")
    # the fps embedding rides the cond dict under the cond_stage2 key
    # (sample_utils.py:71) and is forwarded for ANY conditioning key — the
    # reference threads it through every branch's **kwargs
    # (ddpm3d.py:1369-1433). The reference UNet then swallows it
    # (openaimodel3d.py:632 **kwargs); ours consumes it at the
    # time-embedding site (videocrafter_unet.py), the upstream-VideoCrafter
    # convention, so FPS conditioning is functional.
    kwargs: dict = {
        "context": None,
        "y": None,
        "temporal_context": cond.get("temporal_context"),
    }

    if k is None:
        pass
    elif k == "concat":
        x = _cat_concat(x, cc_list)
    elif k == "crossattn":
        kwargs["context"] = _cat_crossattn(ca_list)
    elif k in ("hybrid", "hybrid-time"):
        # 'hybrid-time' additionally carries s — unused by this UNet
        # (see module docstring)
        x = _cat_concat(x, cc_list)
        kwargs["context"] = _cat_crossattn(ca_list)
    elif k == "resblockcond":
        kwargs["context"] = ca_list[0]
    elif k == "adm":
        kwargs["y"] = ca_list[0]
    elif k == "crossattn-adm":
        kwargs["context"] = _cat_crossattn(ca_list)
        kwargs["y"] = cond.get("s")
    elif k == "hybrid-adm":
        x = _cat_concat(x, cc_list)
        kwargs["context"] = _cat_crossattn(ca_list)
        kwargs["y"] = cond["c_adm"]
    elif k == "hybrid-adm-mask":
        if cc_list is not None:
            x = _cat_concat(x, cc_list)
        kwargs["context"] = _cat_crossattn(ca_list)
        kwargs["y"] = cond.get("s")
    elif k == "concat-time-mask":
        x = _cat_concat(x, cc_list)
    elif k == "concat-adm-mask":
        if cc_list is not None:
            x = _cat_concat(x, cc_list)
        kwargs["y"] = cond.get("s")
    elif k == "hybrid-time-adm":
        x = _cat_concat(x, cc_list)
        kwargs["context"] = _cat_crossattn(ca_list)
        kwargs["y"] = cond["c_adm"]
    else:
        raise NotImplementedError(f"conditioning_key {k!r}")
    return x, kwargs


def normalize_cond(conditioning_key: str | None, cond) -> dict:
    """``apply_model``'s non-dict tolerance (ddpm3d.py:851-858): bare
    tensors/lists become {c_concat|c_crossattn: [cond]}."""
    if isinstance(cond, Mapping):
        return dict(cond)
    if not isinstance(cond, (list, tuple)):
        cond = [cond]
    key = "c_concat" if conditioning_key == "concat" else "c_crossattn"
    return {key: list(cond)}
