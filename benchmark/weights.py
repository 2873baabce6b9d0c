"""Seeded weights, drawn once on the device for the program and again for
the reference.

One ``torch.randn`` of every parameter's elements, in the order of the
reference's ``(name, shape)`` list, from a ``torch.Generator`` on the device
seeded with the run's seed; then each leaf is scaled and rounded to the
dtype the configuration serves in:

* a matrix or convolution kernel: normal with std fan_in^-1/2 (fan_in = the
  product of every axis but the first), the zero-initialised output gates of
  the published models included, so that every layer reaches the output;
* a bias: normal with std 0.02;
* a norm scale: 1 + normal with std 0.02;
* a learned positional embedding: normal with std 0.01.
"""

from __future__ import annotations

import math

import torch


def _scale(name: str, shape) -> tuple[float, float]:
    """(std, mean) of a leaf."""
    if name.endswith("positional_embedding"):
        return 0.01, 0.0
    if len(shape) >= 2:
        return math.prod(shape[1:]) ** -0.5, 0.0
    if name.endswith("bias"):
        return 0.02, 0.0
    return 0.02, 1.0


def draw(shapes, seed: int, device, dtype: torch.dtype):
    """Yield (name, tensor) for every (name, shape) of ``shapes``: the
    seeded values in ``dtype`` on ``device``."""
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for name, shape in shapes:
        n = math.prod(shape)
        std, mean = _scale(name, shape)
        yield name, (flat[off:off + n] * std + mean).to(dtype).view(shape)
        off += n


def state_dict(shapes, seed: int, device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference's weights: the served dtype's values, held in float32."""
    return {name: t.float() for name, t in draw(shapes, seed, device, dtype)}


@torch.no_grad()
def load_into(module: torch.nn.Module, shapes, seed: int) -> None:
    """Fill every parameter of the program's ``module`` with the seeded
    values; its parameters must be exactly the listed names and shapes."""
    params = dict(module.named_parameters())
    want = dict(shapes)
    if set(params) != set(want):
        missing, extra = sorted(set(want) - set(params)), sorted(set(params) - set(want))
        raise ValueError(f"{type(module).__name__}: parameters differ from the reference's: "
                         f"missing {missing[:5]}, extra {extra[:5]}")
    p0 = next(iter(params.values()))
    for name, t in draw(shapes, seed, p0.device, p0.dtype):
        p = params[name]
        if tuple(p.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)}, reference {tuple(t.shape)}")
        p.copy_(t)
