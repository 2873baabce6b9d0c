"""Sampling n videos over a dp x sp x tp process mesh.

The port of the JAX package's ``parallel/dp_sample.py`` (the reference's
DDP sampling: ``n_samples`` split over the ranks, sample i seeded seed + i,
the results gathered to rank 0). The JAX package runs all n samples as one
sharded computation and lets XLA partition it; here every rank runs the
whole sampling loop (``diffusion/sampling.py``) on its own samples, as the
JAX package's ``shard_map`` path does, and the collectives are explicit:

  * dp: the n samples split into contiguous shares (``local_shard``: even
    where dp divides n, as the JAX package splits them; the remainder on
    the first dp indices where it does not, where the JAX package computes
    every sample on every device: the same samples either way). A dp-only
    mesh needs no collective until the gather: every kernel runs unchanged
    at the serial loop's shapes;
  * sp: each rank holds F / sp of every sample's frames, where sp divides
    F (the whole frames on every rank otherwise, as the JAX package's
    ``dp_spec`` replicates them); the UNet gathers frames where it mixes
    them (``parallel/sharding.py``);
  * tp: the UNet's heads and GEGLU width split inside ``sharding.parallel_unet``;
    the sampler's state is whole on every tp rank.

Noise: sample i's starting latent is drawn from the generator seeded seed +
i, exactly as the serial loop's batch i draws it (``core/rng.py``), so a dp
rank reproduces the serial batches bit for bit. The in-loop draws (eta > 0,
Euler a, the inpainting re-noise) continue each sample's own generator, in
the serial loop's order: the JAX package shares one stream there and
promises dp == serial only at eta = 0. Each sp rank draws whole frames and
keeps its own.

vid2vid (``latents`` with ``is_vid2vid``: one source broadcast over the
samples), a masked inpainting start (``latents`` of n rows, with ``mask``
and ``image_latents``), LVDM's static mask and the ``uc_type`` CFG
variants ride the same loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from t2v_torch.core import rng as rng_lib
from t2v_torch.diffusion.sampling import LoopNoise, sample_loop
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.parallel.mesh import ProcessMesh
from t2v_torch.parallel.multihost import local_shard


def sample_generators(seed: int, n: int, device: torch.device | str = "cpu",
                      first: int = 0) -> list[torch.Generator]:
    """The generators of samples ``first`` .. ``first + n - 1``: sample i's
    is seeded seed + i, as the serial loop seeds batch i's."""
    return [rng_lib.generator(seed + first + i, device) for i in range(n)]


def batched_noise(seed: int, n: int, sample_shape: tuple[int, ...],
                  device: torch.device | str = "cpu",
                  first: int = 0) -> tuple[torch.Tensor, list[torch.Generator]]:
    """(n, *sample_shape) float32 noise whose row i is the serial loop's
    starting latent of batch ``first + i``; and the n generators that drew
    it (``sample_generators``), which go on to draw each sample's in-loop
    noise."""
    gens = sample_generators(seed, n, device, first)
    rows = [rng_lib.latent_noise(g, (1, *sample_shape), device) for g in gens]
    return torch.cat(rows or [torch.zeros((0, *sample_shape), device=device)]), gens


def frames_split(frames: int, sp: int) -> bool:
    """Whether the frame axis splits over an sp axis of ``sp`` ranks: only
    where sp divides the frames (the JAX package's ``dp_spec`` rule)."""
    return sp > 1 and frames % sp == 0


def _tile_cond(c, n: int):
    """Tile the batch axis (third from last: (B, L, D) or (S, B, L, D))."""
    if c is None:
        return None
    return c.repeat_interleave(n, dim=c.dim() - 3)


@dataclass
class SampleDraws(LoopNoise):
    """The loop's draws for samples ``rows`` of a request, each from its own
    generator (which drew its starting latent first), whole frames drawn
    and ``frames`` kept; or the rows and frames of the given tables."""

    generators: Sequence[torch.Generator] = ()
    rows: slice = slice(None)
    frames: slice = slice(None)
    full_frames: int = 0

    def _draw(self, table, i: int, like: torch.Tensor) -> torch.Tensor:
        if table is not None:
            t = torch.as_tensor(table[i])[self.rows, self.frames]
            return t.to(device=like.device, dtype=torch.float32)
        shape = (1, self.full_frames, *like.shape[2:])
        return torch.cat([torch.randn(shape, generator=g, device=like.device,
                                      dtype=torch.float32)[:, self.frames]
                          for g in self.generators])


@torch.no_grad()
def dp_sample(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    *,
    steps: int,
    sample_shape: tuple[int, ...],  # (F, h, w, C) of one sample
    n_samples: int,
    cond: torch.Tensor,
    uncond: torch.Tensor | None = None,
    guidance_scale: float = 1.0,
    eta: float = 0.0,
    sampler_name: str = "DDIM_Gaussian",
    seed: int = 0,
    mesh: ProcessMesh | None = None,
    noise: torch.Tensor | None = None,
    parameterization: str = "eps",
    latents: torch.Tensor | None = None,
    is_vid2vid: bool = False,
    strength: float = 1.0,
    mask: torch.Tensor | None = None,
    image_latents: torch.Tensor | None = None,
    inpaint_mode: str = "initial_only",
    cfg_combine_mode: str | None = None,
    step_noise=None,
    inpaint_noise=None,
) -> torch.Tensor | None:
    """Sample ``n_samples`` videos. Without a mesh: one batched loop on this
    process's device, returning (n, F, h, w, C). With one: this rank's
    samples and frames (``apply_fn`` is the rank's UNet, sharded by the
    caller), gathered to rank 0, which returns (n, F, h, w, C); the other
    ranks return None.

    ``noise`` (n, *sample_shape) replaces the seeded starting latents and
    ``step_noise[i]`` / ``inpaint_noise[i]`` (n, *sample_shape) the in-loop
    draws of step i (tests hand in the JAX package's). ``mask`` and
    ``image_latents`` are (1, F, h, w, C), broadcast over the samples."""
    device = cond.device
    frames = sample_shape[0]
    start, count = (0, n_samples) if mesh is None else local_shard(
        n_samples, mesh.dp.size, mesh.dp.index)
    sp = mesh.sp if mesh is not None and frames_split(frames, mesh.sp.size) else None
    fl = frames // sp.size if sp is not None else frames
    fs = slice(sp.index * fl, (sp.index + 1) * fl) if sp is not None else slice(None)
    rows = slice(start, start + count)

    if noise is None:
        noise, gens = batched_noise(seed, count, sample_shape, device, first=start)
    else:  # rows handed in: the generators draw in the loop only, as the serial loop's then
        noise = noise[rows].to(device=device, dtype=torch.float32)
        gens = sample_generators(seed, count, device, first=start)
    if latents is not None:
        ok = (1, n_samples) if is_vid2vid else (n_samples,)
        if latents.shape[0] not in ok:
            raise ValueError(f"latents batch {latents.shape[0]} incompatible with "
                             f"n_samples={n_samples} (is_vid2vid={is_vid2vid})")
        if latents.shape[0] == n_samples:
            latents = latents[rows]
    own = lambda t: None if t is None else t[:, fs]

    x0 = own(noise)
    if count:
        x0 = sample_loop(
            apply_fn, schedule, steps=steps, shape=(count, fl, *sample_shape[1:]),
            cond=_tile_cond(cond, count), uncond=_tile_cond(uncond, count),
            guidance_scale=guidance_scale, eta=eta, sampler_name=sampler_name,
            noise=x0, latents=own(latents), is_vid2vid=is_vid2vid, strength=strength,
            mask=own(mask), image_latents=own(image_latents), inpaint_mode=inpaint_mode,
            cfg_combine_mode=cfg_combine_mode, parameterization=parameterization,
            device=device,
            draws=SampleDraws(step_noise=step_noise, inpaint_noise=inpaint_noise,
                              generators=gens, rows=rows, frames=fs, full_frames=frames),
        )
    if mesh is None:
        return x0
    if sp is not None:
        x0 = sp.all_gather(x0, dim=1)
    counts = [local_shard(n_samples, mesh.dp.size, d)[1] for d in range(mesh.dp.size)]
    return mesh.gather_samples(x0, counts)
