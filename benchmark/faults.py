"""Faults planted underneath the harness, to show that the check catches
them, and their readings on the card.

    python3 benchmark/faults.py --workload <cell> --fault <name> --seeds <n> [<n> ...]

Each planter takes an object with ``setattr(obj, name, value)`` (pytest's
``monkeypatch``, or ``Patch`` here) and replaces one piece of the port:

* ``step_unchanged``: a sampler step returns its state unchanged;
* ``half_batch``: the UNet computes half of its batch and fills the rest
  with the mean of that half;
* ``frame_altered``: the decode adds 24 levels to the first frame it makes;
* ``exchange_skipped``: the UNet's frame-mixing blocks run on a rank's own
  frames, the exchange between the cards left out (cells over several
  cards);
* ``state_unchanged``: a training step leaves the adapter as it was;
* ``half_loss``: the loss takes half of the batch, its mean over the rest;
* ``gradient_altered``: the largest gradient leaf of a step is doubled.

For each seed the script runs the cell with the fault planted in every
rank (a window of the units the check captures) and prints its compared
numbers beside their limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Patch:
    """``setattr`` that remembers what it replaced; ``undo`` restores it."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def step_unchanged(patch):
    from t2v_torch.diffusion import ddim, ddim_gaussian

    for mod in (ddim, ddim_gaussian):
        patch.setattr(mod, "step", lambda x, eps, p, i, noise: x)


def half_batch(patch):
    from benchmark import program

    build = program.build

    def built(*args, **kwargs):  # the built pipeline's UNet class, patched
        pipe = build(*args, **kwargs)
        cls = type(pipe.unet)
        orig = cls.forward

        def half(self, x, t, context, *a, **k):
            b = x.shape[0] // 2
            out = orig(self, x[:b], t[:b], context[:b], *a, **k)
            return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - b, *out.shape[1:])])

        patch.setattr(cls, "forward", half)
        return pipe

    patch.setattr(program, "build", built)


def frame_altered(patch):
    from t2v_torch.pipeline import pipeline

    orig = pipeline.decode_uint8

    def altered(vae, z, scale):
        img = orig(vae, z, scale).clone()
        img[0] = (img[0].int() + 24).clamp(0, 255).to(img.dtype)
        return img

    patch.setattr(pipeline, "decode_uint8", altered)


def exchange_skipped(patch):
    from t2v_torch.models import blocks

    patch.setattr(blocks, "frames_gathered", lambda forward, x, sp, frames_dim=1: forward(x))


def state_unchanged(patch):
    from t2v_torch.parallel.train import TrainStep

    patch.setattr(TrainStep, "apply_gradients", lambda self, state, grads: state)


def half_loss(patch):
    from t2v_torch.parallel import train

    orig = train.diffusion_loss

    def half(apply_fn, params, tables, batch, generator, *a, **k):
        b = batch["latents"].shape[0] // 2
        return orig(apply_fn, params, tables, {key: v[:b] for key, v in batch.items()},
                    generator, *a, **k)

    patch.setattr(train, "diffusion_loss", half)


def gradient_altered(patch):
    from t2v_torch.parallel.train import TrainStep

    orig = TrainStep.loss_and_grads

    def altered(self, *a, **k):
        loss, grads = orig(self, *a, **k)
        i = max(range(len(grads)), key=lambda j: float(grads[j].norm()))
        grads[i] = grads[i] * 2
        return loss, grads

    patch.setattr(TrainStep, "loss_and_grads", altered)


REQUEST = {"step_unchanged": step_unchanged, "half_batch": half_batch,
           "frame_altered": frame_altered}
TRAINING = {"state_unchanged": state_unchanged, "half_loss": half_loss,
            "gradient_altered": gradient_altered}
EXCHANGE = {"exchange_skipped": exchange_skipped}
ALL = {**REQUEST, **TRAINING, **EXCHANGE}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` planted while the block runs (nothing for None)."""
    patch = Patch()
    if name is not None:
        ALL[name](patch)
    try:
        yield
    finally:
        patch.undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(ALL))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ns = ap.parse_args(argv)
    from benchmark import run, spec

    run.cache_env(ROOT)
    cell = spec.cell(ns.workload)
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in ns.seeds:
        res, _ = run.launch(cell, seed, 0.0, False, device_type, fault=ns.fault)
        print(json.dumps({"workload": ns.workload, "fault": ns.fault, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
