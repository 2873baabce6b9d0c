"""Faults planted underneath the harness, to show that the check catches
them, and their readings on the card.

    python3 benchmark/faults.py --workload <cell> --fault <name> --seeds <n> [<n> ...]

Each planter takes an object with ``setattr(obj, name, value)`` (pytest's
``monkeypatch``, or ``Patch`` here) and replaces one piece of the port:

* ``step_unchanged``: a sampler step returns its state unchanged;
* ``half_batch``: the UNet computes half of its batch and fills the rest
  with the mean of that half;
* ``frame_altered``: the decode adds 24 levels to the first frame it makes;
* ``state_unchanged``: a training step leaves the adapter as it was;
* ``half_loss``: the loss takes half of the batch, its mean over the rest;
* ``gradient_altered``: the largest gradient leaf of a step is doubled.

The exchange between chips is a fault of four-chip cells; every cell of
this benchmark runs on one. For each seed the script runs the cell with
the fault planted (a window of one unit) and prints its compared numbers
beside their limits.
"""

from __future__ import annotations

import argparse
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
    from t2v_torch.models.modelscope_unet import UNetSD
    from t2v_torch.models.videocrafter_unet import VideoCrafterUNet

    for cls in (UNetSD, VideoCrafterUNet):
        orig = cls.forward

        def half(self, x, t, context, *a, _orig=orig, **k):
            b = x.shape[0] // 2
            out = _orig(self, x[:b], t[:b], context[:b], *a, **k)
            return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - b, *out.shape[1:])])

        patch.setattr(cls, "forward", half)


def frame_altered(patch):
    from t2v_torch.pipeline import pipeline

    orig = pipeline.decode_uint8

    def altered(vae, z, scale):
        img = orig(vae, z, scale).clone()
        img[0] = (img[0].int() + 24).clamp(0, 255).to(img.dtype)
        return img

    patch.setattr(pipeline, "decode_uint8", altered)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted({**REQUEST, **TRAINING}))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ns = ap.parse_args(argv)
    from benchmark import run, spec

    run.cache_env(ROOT)
    cell = spec.cell(ns.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in ns.seeds:
        patch = Patch()
        {**REQUEST, **TRAINING}[ns.fault](patch)
        try:
            res, _ = run.run_cell(cell, seed, 0.0, False, device)
        finally:
            patch.undo()
        print(json.dumps({"workload": ns.workload, "fault": ns.fault, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
