"""The LVDM LoRA utility zoo as functions over the port's LoRA tree.

The port of the JAX package's ``pipeline/lora_zoo.py``. The reference's
toolkit (lvdm ``lora.py``) patches torch modules in place; here a LoRA is
its own tree ``{module_name: {"lora_A": (in, r), "lora_B": (r, out)[,
"scale", "diag"]}}`` of tensors (``pipeline/lora.py``), and each of the
toolkit's operations is a function that returns a new tree or state dict:

  reference (lora.py)                     | here
  ----------------------------------------|---------------------------------
  extract_lora_ups_down / save (:384-437) | lora_to_flat_weights
  monkeypatch_or_replace_lora (:813)      | flat_weights_to_lora
  monkeypatch_add_lora (:991)             | add_lora (alpha / beta blend)
  tune_lora_scale (:1018)                 | tune_lora_scale
  set_lora_diag (:1024)                   | set_lora_diag
  collapse_lora (:776)                    | collapse_lora -> base state dict
  inspect_lora (:1167)                    | inspect_lora
  save_safeloras_with_embeds (:452)       | save_safeloras_with_embeds
  parse_safeloras[_embeds] (:539-617)     | parse_safeloras[_embeds]
  patch_pipe (:1099)                      | patch_safeloras
  save_all (:1186)                        | save_all

The wrapper's forward is ``W x + up(diag(down(x))) * scale``, so the merged
delta is ``B^T diag(d) A^T * scale`` in torch layout; ``apply_lora`` and
``effective_delta`` honour ``scale`` and ``diag``, ``collapse_lora`` uses the
raw factors, as the reference's does.

The container is the reference's: weights ``{model}:{i}:up`` /
``{model}:{i}:down`` in float16, ``i`` enumerating the target modules in
module-index order (the reference's ``named_modules`` order); metadata
``{model}`` -> JSON list of target class names, ``{model}:{i}:rank`` -> rank,
and each textual-inversion token -> ``EMBED_FLAG`` beside its float32 rows.
"""

from __future__ import annotations

import json
from typing import Callable, Iterable, Mapping, Sequence

import torch

from t2v_torch.io.safetensors_io import load_torch, save_torch
from t2v_torch.pipeline.lora import ModuleIndex, apply_lora

EMBED_FLAG = "<embed>"

# the reference's target sets (lora.py:158-166), written into the
# container's metadata; selection here goes by module kind
UNET_DEFAULT_TARGET_REPLACE = {
    "MemoryEfficientCrossAttention", "CrossAttention", "Attention", "GEGLU",
}
TEXT_ENCODER_DEFAULT_TARGET_REPLACE = {"CLIPAttention"}


def _t(x) -> torch.Tensor:
    """A factor as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def lora_module_order(module_index: ModuleIndex,
                      include: Callable[[str, str], bool] | None = None) -> list[str]:
    """The LoRA-targeted modules in enumeration order: the index's order
    (the torch topology's walk, as ``named_modules`` gives it), filtered by
    ``include(name, kind)``, by default the linear modules."""
    include = include or (lambda name, kind: kind == "linear")
    return [n for n, (_p, kind) in module_index.items() if include(n, kind)]


def lora_to_flat_weights(lora: Mapping[str, dict],
                         order: Sequence[str] | None = None) -> list[torch.Tensor]:
    """LoRA tree -> the reference's flat ``[up0, down0, up1, down1, ...]``
    float16 list; a module's ``scale`` folds into its up factor, its
    ``diag`` does not (``realize_as_lora``)."""
    flat: list[torch.Tensor] = []
    for name in (list(order) if order is not None else list(lora)):
        ab = lora[name]
        up = _t(ab["lora_B"]).T * float(ab.get("scale", 1.0))  # (out, r)
        down = _t(ab["lora_A"]).T  # (r, in)
        flat += [up.to(torch.float16).contiguous(), down.to(torch.float16).contiguous()]
    return flat


def flat_weights_to_lora(weights: Iterable, order: Sequence[str]) -> dict[str, dict]:
    """``[up, down]`` pairs in module order -> a fresh float32 LoRA tree;
    conv-shaped factors squeeze their trailing singleton dims."""
    it = iter(weights)
    lora: dict[str, dict] = {}
    for name in order:
        up, down = _t(next(it)), _t(next(it))
        while up.dim() > 2:
            up = up.squeeze(-1)
        while down.dim() > 2:
            down = down.squeeze(-1)
        lora[name] = {"lora_A": down.T.contiguous(), "lora_B": up.T.contiguous()}
    return lora


def add_lora(lora: Mapping[str, dict], new: Mapping[str, dict], alpha: float = 1.0,
             beta: float = 1.0) -> dict[str, dict]:
    """Factor-wise blend ``new * alpha + lora * beta``; a module in one tree
    only keeps its factors, scaled by its tree's weight. ``scale`` / ``diag``
    come from ``lora`` where it has them, else from ``new``."""
    out: dict[str, dict] = {}
    for name in [*lora, *(n for n in new if n not in lora)]:
        a, b = lora.get(name), new.get(name)
        out[name] = {
            f: (0.0 if b is None else _t(b[f]) * alpha) + (0.0 if a is None else _t(a[f]) * beta)
            for f in ("lora_A", "lora_B")
        }
        for extra in ("scale", "diag"):
            src = a if (a is not None and extra in a) else b
            if src is not None and extra in src:
                out[name][extra] = src[extra]
    return out


def tune_lora_scale(lora: Mapping[str, dict], alpha: float = 1.0) -> dict[str, dict]:
    """Every module's runtime scale set to ``alpha``."""
    return {n: dict(ab, scale=float(alpha)) for n, ab in lora.items()}


def set_lora_diag(lora: Mapping[str, dict], diag) -> dict[str, dict]:
    """A per-rank selector ``diag(d)`` between down and up in every module;
    ``diag`` has shape (r,)."""
    diag = _t(diag)
    out = {}
    for n, ab in lora.items():
        r = ab["lora_A"].shape[-1]
        if tuple(diag.shape) != (r,):
            raise ValueError(f"diag shape {tuple(diag.shape)} != rank ({r},) for {n}")
        out[n] = dict(ab, diag=diag)
    return out


def effective_delta(ab: Mapping) -> torch.Tensor:
    """A module's merged delta ``A diag(d) B * scale``, (in, out)."""
    a = _t(ab["lora_A"])
    if "diag" in ab:
        a = a * _t(ab["diag"])[None, :]
    return (a @ _t(ab["lora_B"])) * float(ab.get("scale", 1.0))


def collapse_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, dict],
                  module_index: ModuleIndex, alpha: float = 1.0) -> dict[str, torch.Tensor]:
    """Fold ``up @ down * alpha`` into the base weights (a state dict) with
    the raw factors: runtime ``scale`` and ``diag`` are ignored, as the
    reference's ``collapse_lora`` reads the factors' weights directly."""
    raw = {n: {"lora_A": ab["lora_A"], "lora_B": ab["lora_B"]} for n, ab in lora.items()}
    return apply_lora(params, raw, module_index, alpha=alpha)


def inspect_lora(lora: Mapping[str, dict]) -> dict[str, float]:
    """Mean |up @ down| of each module (the reference's training-drift
    print)."""
    return {name: float((_t(ab["lora_B"]).T @ _t(ab["lora_A"]).T).abs().mean())
            for name, ab in lora.items()}


# ---------------------------------------------------------------------------
# the safeloras container


def save_safeloras_with_embeds(
    loramap: Mapping[str, tuple[Mapping[str, dict], Iterable[str]]],
    embeds: Mapping | None = None,
    outpath: str = "./lora.safetensors",
    orders: Mapping[str, Sequence[str]] | None = None,
) -> str:
    """Write the reference's multi-model container. ``loramap`` maps a model
    name to (LoRA tree, target class names); ``orders`` pins a model's
    module order (by default its tree's)."""
    weights: dict[str, torch.Tensor] = {}
    metadata: dict[str, str] = {}
    for name, (lora, targets) in loramap.items():
        metadata[name] = json.dumps(sorted(targets))
        order = list(orders[name]) if orders and name in orders else list(lora)
        flat = lora_to_flat_weights(lora, order)
        for i in range(len(order)):
            up, down = flat[2 * i], flat[2 * i + 1]
            metadata[f"{name}:{i}:rank"] = str(down.shape[0])
            weights[f"{name}:{i}:up"] = up
            weights[f"{name}:{i}:down"] = down
    for token, tensor in (embeds or {}).items():
        metadata[token] = EMBED_FLAG
        weights[token] = _t(tensor).contiguous()
    return save_torch(outpath, weights, metadata)


def save_safeloras(loramap, outpath: str = "./lora.safetensors", orders=None) -> str:
    """The container without embeddings."""
    return save_safeloras_with_embeds(loramap, None, outpath, orders)


def parse_safeloras(path: str) -> dict[str, tuple[list[torch.Tensor], list[int], list[str]]]:
    """Container -> {model: (flat [up, down, ...] weights, ranks, target
    class names)}. A weight whose model has no metadata entry is refused."""
    tensors, metadata = load_torch(path)
    by_model: dict[str, list[str]] = {}
    for key in tensors:
        name = key.split(":")[0]
        if metadata.get(name) in (None, EMBED_FLAG):
            if metadata.get(name) is None and ":" in key:
                raise ValueError(f"Tensor {name} has no metadata - is this a Lora safetensor?")
            continue
        by_model.setdefault(name, []).append(key)
    loras = {}
    for name, keys in by_model.items():
        n = len(keys) // 2
        ranks = [4] * n
        weights: list = [None] * len(keys)
        for key in keys:
            _, idx, direction = key.split(":")
            idx = int(idx)
            ranks[idx] = int(metadata[f"{name}:{idx}:rank"])
            weights[idx * 2 + (1 if direction == "down" else 0)] = tensors[key]
        loras[name] = (weights, ranks, json.loads(metadata[name]))
    return loras


def parse_safeloras_embeds(path: str) -> dict[str, torch.Tensor]:
    """Container -> {token: textual-inversion rows}."""
    tensors, metadata = load_torch(path)
    return {k: v for k, v in tensors.items() if metadata.get(k) == EMBED_FLAG}


def patch_safeloras(
    path: str,
    params_map: Mapping[str, Mapping[str, torch.Tensor]],
    module_indices: Mapping[str, ModuleIndex],
    embedding_db=None,
    alpha: float = 1.0,
) -> dict[str, dict[str, torch.Tensor]]:
    """Merge every model's factors of a container into the state dict of
    ``params_map`` under the same name, and register its embeddings in
    ``embedding_db``. Returns {model: merged state dict}; a model of the
    container with no state dict given is passed over. A model's factors
    pair with its linear modules that have a 2-D weight, in index order."""
    out = {}
    for name, (weights, _ranks, _targets) in parse_safeloras(path).items():
        if name not in params_map:
            continue
        params, index = params_map[name], module_indices[name]
        order = [n for n in lora_module_order(index)
                 if index[n][0] in params and params[index[n][0]].dim() == 2]
        lora = flat_weights_to_lora(weights, order[: len(weights) // 2])
        lora = {n: {k: v.to(params[index[n][0]].device) for k, v in ab.items()}
                for n, ab in lora.items()}
        out[name] = apply_lora(params, lora, index, alpha=alpha)
    if embedding_db is not None:
        for token, vec in parse_safeloras_embeds(path).items():
            vec = vec.float().numpy()
            embedding_db.register(token, vec[None] if vec.ndim == 1 else vec)
    return out


def save_all(
    unet_lora: Mapping[str, dict],
    text_lora: Mapping[str, dict] | None,
    save_path: str,
    embeds: Mapping | None = None,
    unet_targets: Iterable[str] = UNET_DEFAULT_TARGET_REPLACE,
    text_targets: Iterable[str] = TEXT_ENCODER_DEFAULT_TARGET_REPLACE,
) -> str:
    """One container holding the UNet LoRA, the text-encoder LoRA and the
    learned embeddings."""
    if not save_path.endswith(".safetensors"):
        raise ValueError(f"Save path : {save_path} should end with .safetensors")
    loramap = {"unet": (unet_lora, unet_targets)}
    if text_lora is not None:
        loramap["text_encoder"] = (text_lora, text_targets)
    return save_safeloras_with_embeds(loramap, embeds, save_path)
