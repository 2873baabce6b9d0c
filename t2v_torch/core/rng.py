"""Seed policy of the port.

* ``seed == -1`` means "random": it is resolved to a concrete seed before
  any draw, so the infotext records the seed used;
* the batch at index i uses ``seed + i`` (the reference's rule);
* latent noise is drawn in fp32 from an explicit ``torch.Generator`` on the
  device. Its bits differ from the JAX package's; tests hand both packages
  the same numpy noise instead.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_seed(seed: int) -> int:
    """Map the ``-1`` 'randomise' sentinel to a fresh seed."""
    if seed == -1:
        return int(np.random.SeedSequence().entropy % (2**31))
    return int(seed)


def batch_seed(seed: int, batch_index: int) -> int:
    return seed + batch_index


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    if seed < 0:
        raise ValueError("resolve seed=-1 to a concrete seed before drawing")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def latent_noise(
    gen: torch.Generator, shape: tuple[int, ...], device: torch.device | str
) -> torch.Tensor:
    """Initial latent noise, fp32 regardless of the compute policy."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
