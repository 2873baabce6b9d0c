"""Whether the LoRA training steps the trainer took are correct.

The plain float32 reference repeats the set-up's first steps from the
benchmark's own inputs (the seeded base weights and adapter, the clips,
the captions, the step seed's (t, noise) draws): the clips' encode with the
reference VAE, the captions with the reference text tower, the adapter
merged into every linear weight (W + alpha·(A B)ᵀ), the denoising MSE of the
reference UNet (one sample at a time, the gradients summed), and AdamW. It
compares, each by its worst:

* ``loss``: the first step's loss, relative to the reference's;
* ``grad``: the first step's gradient of each adapter leaf as AdamW holds it
  (its first moment over 1 - beta1): the gap between the program's norm and
  the reference's, over the larger of the reference's norm of that leaf and
  of the median leaf; the worst leaf;
* ``change``: the change of each leaf over the checked steps, by the same
  measure; the median leaf. Leaves whose reference gradient lies under a
  thousandth of the median leaf's are left out (they move by round-off
  alone).

The later steps' losses and the worst leaf's change are printed beside them
(``notes``), not compared: AdamW's first updates are close to lr·sign(m) for
every element, so an element whose first moment lies at round-off moves a
full step in a direction the rounding picks, and on some seeds the adapter,
then a later loss, part from the reference's by that noise. On the card two
seeds of twelve read a worst leaf's change of 0.149 and 0.249 and a later
loss 1.25% and 8.1% off; the reference itself on bf16-rounded operands
parts on the same two seeds by as much (0.162 and 0.118; 0.21% and 3.3%)
and not on a sound one (0.008; 7e-5), and 97-100% of the worst leaf's
elements that parted had a first moment at round-off
(``benchmark/look_lora.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, spec
from benchmark.loops import lora_train as lt
from benchmark.reference import sampling, text
from benchmark.reference.ops import Ops, strict_fp32

NAMES = ("loss", "grad", "change")
SMALL = 1e-3  # a leaf whose first gradient is under this share of the median leaf's


def norm_gaps(got: dict, want: dict) -> list[float]:
    """Per leaf: | |got| - |want| | / max(|want|, the median leaf's |want|)."""
    w = {n: float(want[n].norm()) for n in want}
    med = float(np.median(list(w.values())))
    return [abs(float(got[n].float().norm()) - w[n]) / max(w[n], med, 1e-30) for n in want]


def reference_steps(cfg: dict, traffic: dict, run_seed: int, device, dtype, ops: Ops,
                    sd: dict | None = None, on_step=None):
    """(losses, first gradients, adapter after the steps) of the reference,
    the adapter leaves named "module.lora_A" / "module.lora_B";
    ``on_step(step, t, leaves, opt)`` is called after each update."""
    tr = traffic
    s = lt.seeds(run_seed)
    sd = sd or program.reference_weights(cfg, run_seed, device, dtype)
    fam = spec.family(cfg)
    tok = text.Tokenizer(cfg["tokenizer"]["merge_words"])
    unet_shapes = program.param_shapes(cfg)["unet"]
    tree = lt.draw_lora(unet_shapes, tr["lora_rank"], s["lora"], device)
    leaves = {f"{m}.{k}": t.requires_grad_(True) for m, ab in tree.items() for k, t in ab.items()}
    opt = torch.optim.AdamW(list(leaves.values()), lr=tr["lr"], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tr["weight_decay"])
    clips = lt.draw_clips(tr, s["clips"], device)
    caps = lt.captions(tr, tok, s["clips"])
    gen = torch.Generator(device=device)
    gen.manual_seed(s["steps"])
    ac = sampling.alphas_cumprod()
    sa = torch.tensor(np.sqrt(ac).astype(np.float32), device=device)
    s1 = torch.tensor(np.sqrt(1.0 - ac).astype(np.float32), device=device)
    scale = cfg["vae"]["scale_factor"]
    losses, grad1 = [], {}
    for step in range(tr["checked_steps"]):
        picked = lt.batch_of(tr, step)
        with torch.no_grad():
            lat = torch.stack([torch.cat([fam.VAE.encode_mean(sd["vae"], cfg["vae"], torch.as_tensor(
                clips[k][i:i + 8], device=device), ops) for i in range(0, tr["frames"], 8)]) * scale
                for k in picked])
            ctx = torch.cat([fam.context(sd, cfg, tok, caps[k], ops) for k in picked])
        t = torch.randint(0, sampling.T, (len(picked),), generator=gen, device=device)
        noise = torch.randn(lat.shape, generator=gen, device=device, dtype=torch.float32)
        total = 0.0
        for k in range(len(picked)):  # one sample at a time; the gradients sum
            merged = dict(sd["unet"])
            for m, ab in tree.items():
                merged[f"{m}.weight"] = sd["unet"][f"{m}.weight"] + (ab["lora_A"] @ ab["lora_B"]).T * tr["lora_alpha"]
            xt = sa[t[k]] * lat[k:k + 1] + s1[t[k]] * noise[k:k + 1]
            pred = fam.UNET.forward(merged, cfg["unet"], xt, t[k:k + 1].float(), ctx[k:k + 1], ops)
            term = ((pred - noise[k:k + 1]) ** 2).sum() / noise.numel()
            term.backward()
            total += float(term.detach())
        losses.append(total)
        if step == 0:
            grad1 = {n: p.grad.detach().clone() for n, p in leaves.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        if on_step is not None:
            on_step(step, t, leaves, opt)
    return losses, grad1, {n: p.detach() for n, p in leaves.items()}, tree


def judge(cfg, traffic, cap, run_seed, device, dtype, ops: Ops, sd=None) -> dict:
    losses, grad1, after, _ = reference_steps(cfg, traffic, run_seed, device, dtype, ops, sd)
    start = lt.draw_lora(program.param_shapes(cfg)["unet"], traffic["lora_rank"],
                          lt.seeds(run_seed)["lora"], device)
    start = {f"{m}.{k}": t for m, ab in start.items() for k, t in ab.items()}
    med = float(np.median([float(g.norm()) for g in grad1.values()]))
    moving = {n for n, g in grad1.items() if float(g.norm()) >= SMALL * med}
    if len(cap.losses) != len(losses) or set(cap.grad1) != set(grad1):
        return dict.fromkeys(NAMES, 1e9)  # a missing step or leaf fails every number
    change = norm_gaps({n: cap.lora[n].to(device) - start[n] for n in moving},
                       {n: after[n] - start[n] for n in moving})
    return {
        "loss": abs(cap.losses[0] - losses[0]) / abs(losses[0]),
        "grad": max(norm_gaps(cap.grad1, grad1)),
        "change": float(np.median(change)),
        "notes": {"loss_any_step": max(abs(a - b) / abs(b) for a, b in zip(cap.losses, losses)),
                  "change_worst_leaf": max(change), "left_out": len(grad1) - len(moving)},
    }


def check(cfg: dict, traffic: dict, captures: list, run_seed: int, device, dtype,
          check_spec: dict) -> dict:
    """Judge the set-up's checked steps against the float32 reference."""
    with strict_fp32():
        return judge(cfg, traffic, captures[0], run_seed, device, dtype, Ops())


def control(cfg: dict, traffic: dict, run_seed: int, device, dtype, sd: dict | None = None):
    """The control: the reference's steps with float8 operands, in the
    loop's capture format, for ``judge``."""
    with strict_fp32():
        losses, grad1, after, _ = reference_steps(cfg, traffic, run_seed, device, dtype,
                                                  Ops(fp8=True), sd)
    cap = lt.Capture()
    cap.losses, cap.grad1, cap.lora = losses, grad1, after
    return cap
