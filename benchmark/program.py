"""The system under test: the port's pipelines, built from a configuration
file with the benchmark's seeded weights.

The port is imported here, in the family files and in the loops only,
inside functions, so that the reference and the rest of the harness load
without it.
"""

from __future__ import annotations

import torch

from benchmark import spec, weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def latent_shape(cfg: dict, traffic: dict) -> tuple[int, int, int, int]:
    """(F, h, w, C) of one video's latent under the config's VAE."""
    down = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    c = spec.family(cfg).latent_channels(cfg)
    return traffic["frames"], traffic["height"] // down, traffic["width"] // down, c


def seeds(cfg: dict, run_seed: int) -> dict:
    """The weight seed of each section of the family's model: the run's
    seed, then one more for each section in the family's order."""
    return {s: int(run_seed) + i for i, s in enumerate(spec.family(cfg).SECTIONS)}


def param_shapes(cfg: dict) -> dict:
    """(name, shape) lists of each section of the model (a UNet, a VAE, a
    text tower)."""
    return spec.family(cfg).param_shapes(cfg)


def build(cfg: dict, run_seed: int, device) -> object:
    """The port's pipeline of ``cfg`` on ``device``, in the config's dtype,
    holding the seeded weights."""
    from t2v_torch.core.dtypes import Policy

    pipe, modules = spec.family(cfg).build(cfg, Policy(param_dtype=DTYPES[cfg["dtype"]]), device)
    shapes, s = param_shapes(cfg), seeds(cfg, run_seed)
    for key, module in modules.items():
        weights.load_into(module, shapes[key], s[key])
    return pipe


def reference_weights(cfg: dict, run_seed: int, device, dtype: torch.dtype) -> dict:
    """The same weights for the reference, float32 on ``device``: the values
    of ``dtype`` the program holds."""
    shapes, s = param_shapes(cfg), seeds(cfg, run_seed)
    return {k: weights.state_dict(shapes[k], s[k], device, dtype) for k in shapes}
