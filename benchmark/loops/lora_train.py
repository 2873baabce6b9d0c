"""LoRA fine-tuning steps of the trainer CLI (``t2v_torch/cli/train.py``)
on one card: per step every clip through ``pipe.compute_latents``, every
caption through the text encoder, then one step of
``parallel/train.make_lora_train_step``.

The clips (``clips`` of them, ``frames`` x ``resolution``² RGB in [-1, 1],
smooth noise drawn on the card from the seed) and their captions (drawn as
request prompts are) are made in set-up and held in host memory, as the
dataset hands the trainer numpy batches; step i takes clips
``batch_size·i .. batch_size·(i+1) - 1`` modulo their number. WebVid's disk
reader is left out.

Set-up builds one train state and one step, drives them through the first
``checked_steps`` steps (every shape warmed; the clips of those steps all
differ) and keeps what the reference compares: each step's loss, the first
step's gradients as AdamW holds them (its first moment over 1 - beta1), and
the adapter after the last of those steps. The window goes on with the same
state. The LoRA factors are drawn by the benchmark from the seed, B as well
as A non-zero (the port's ``init_lora`` sets B to 0, which would make every
A's first gradient exactly 0), as the models' zero-initialised gates are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import program, prompts, spans, spec
from benchmark.reference.text import Tokenizer

KEYS = frozenset({"why", "loop", "batch_size", "frames", "resolution", "clips", "lora_rank",
                  "lora_alpha", "lr", "weight_decay", "checked_steps", "trace_units", "prompt"})


def lora_shapes(unet_shapes, rank: int) -> list:
    """(module, A shape, B shape) of every adapted module: each 2-D weight
    of the UNet (its linear layers), A (in, rank), B (rank, out)."""
    return [(name[: -len(".weight")], (s[1], rank), (rank, s[0]))
            for name, s in unet_shapes if name.endswith(".weight") and len(s) == 2]


def draw_lora(unet_shapes, rank: int, seed: int, device) -> dict:
    """The seeded initial adapter, float32: A ~ N(0, 1) / rank, B ~ N(0, 1e-3²)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tree = {}
    for mod, sa, sb in lora_shapes(unet_shapes, rank):
        a = torch.randn(sa, generator=gen, device=device) / rank
        b = torch.randn(sb, generator=gen, device=device) * 1e-3
        tree[mod] = {"lora_A": a, "lora_B": b}
    return tree


def draw_clips(traffic: dict, seed: int, device) -> np.ndarray:
    """(clips, F, H, W, 3) float32 in (-1, 1): noise at 1/8 resolution,
    bilinearly upsampled, through tanh."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n, f, r = traffic["clips"], traffic["frames"], traffic["resolution"]
    low = torch.randn(n * f, 3, r // 8, r // 8, generator=gen, device=device)
    x = torch.tanh(F.interpolate(low, size=(r, r), mode="bilinear", align_corners=False))
    return x.permute(0, 2, 3, 1).reshape(n, f, r, r, 3).cpu().numpy()


def captions(traffic: dict, tok: Tokenizer, seed: int) -> list[str]:
    return [prompts.prompt(traffic["prompt"], tok, prompts.request_rng(seed, i, stream=4))
            for i in range(traffic["clips"])]


def seeds(run_seed: int) -> dict:
    """Seeds of the adapter, the clips and the steps' (t, noise) draws."""
    return {"lora": int(run_seed) + 3, "clips": int(run_seed) + 4, "steps": int(run_seed) + 5}


def batch_of(traffic: dict, step: int) -> list[int]:
    b, n = traffic["batch_size"], traffic["clips"]
    return [(b * step + k) % n for k in range(b)]


class Capture:
    def __init__(self):
        self.losses: list[float] = []
        self.grad1: dict = {}  # "module.lora_A" -> first step's gradient
        self.lora: dict = {}  # "module.lora_A" -> the adapter after the checked steps


class Loop:
    def __init__(self, cfg: dict, traffic: dict, run_seed: int, device, peaks: dict | None):
        spec.only_keys(traffic, KEYS, "lora_train")
        if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
            raise ValueError("the lora_train loop runs on one card")
        self.cfg, self.traffic, self.run_seed, self.device = cfg, traffic, int(run_seed), device
        self.tok = Tokenizer(cfg["tokenizer"]["merge_words"])
        self.timer = spans.Timer()
        self.annot = spans.Annotator(peaks)
        self.capture = None
        self.checked = Capture()
        self.setup_captures = [self.checked]
        self.reset()

    def setup(self) -> None:
        from t2v_torch.parallel.train import (init_train_state, make_lora_train_step,
                                              make_optimizer, module_apply_fn, tree_items)
        from t2v_torch.pipeline.lora import init_lora, unet_module_index

        tr, dev = self.traffic, self.device
        s = seeds(self.run_seed)
        self.pipe = pipe = program.build(self.cfg, self.run_seed, dev)
        base = dict(pipe.unet.named_parameters())
        index = unet_module_index(spec.family(self.cfg).unet_config(self.cfg))
        tree = init_lora(base, index, tr["lora_rank"], torch.Generator(device=dev).manual_seed(0))
        drawn = draw_lora(program.param_shapes(self.cfg)["unet"], tr["lora_rank"], s["lora"], dev)
        if set(tree) != set(drawn):
            raise ValueError(f"the port adapts {len(tree)} modules, the benchmark draws {len(drawn)}")
        with torch.no_grad():
            for mod, ab in tree.items():
                for k in ("lora_A", "lora_B"):
                    ab[k].copy_(drawn[mod][k])
        opt = make_optimizer(tr["lr"], tr["weight_decay"])
        self.state = init_train_state(tree, opt)
        self.step_fn = make_lora_train_step(module_apply_fn(pipe.unet), pipe.schedule, base, index,
                                            alpha=tr["lora_alpha"], parameterization="eps")
        self.gen = torch.Generator(device=dev).manual_seed(s["steps"])
        self.clips = draw_clips(tr, s["clips"], dev)
        self.captions = captions(tr, self.tok, s["clips"])
        self.timer.watch(pipe.unet, "unet_call")
        self.annot.watch(pipe.unet, "unet_call")
        encode = pipe.compute_latents

        def compute_latents(frames):
            if self.timer.on:
                a = torch.cuda.Event(enable_timing=True)
                a.record()
            with self.annot.span("vae_encode"):
                out = encode(frames)
            if self.timer.on:
                b = torch.cuda.Event(enable_timing=True)
                b.record()
                self.timer.pairs["vae_encode"].append((a, b))
            return out

        pipe.compute_latents = compute_latents
        items = lambda: tree_items(self.state.params)
        beta1 = opt.keywords["betas"][0]
        for i in range(tr["checked_steps"]):
            loss = self.unit(i)
            self.checked.losses.append(float(loss))
            if i == 0:  # a leaf AdamW holds no moment of has had no gradient
                states = self.state.opt_state.state
                self.checked.grad1 = {
                    n: states[p]["exp_avg"].detach() / (1 - beta1) if "exp_avg" in states.get(p, {})
                    else torch.zeros_like(p) for n, p in items()}
        self.checked.lora = {n: p.detach().clone() for n, p in items()}
        self.first = tr["checked_steps"]

    def reset(self) -> None:
        self.steps = 0
        self.counting = True

    def new_capture(self):
        return Capture()

    def unit(self, i: int):
        """One training step on batch ``first + i`` (the checked steps are
        0 .. checked_steps - 1); returns the loss (a device tensor)."""
        step = i + getattr(self, "first", 0)
        pipe = self.pipe
        picked = batch_of(self.traffic, step)
        latents = torch.cat([pipe.compute_latents(self.clips[k]) for k in picked], dim=0)
        context = torch.cat([pipe.text_encoder.encode_line(self.captions[k])[None] for k in picked])
        self.state, loss = self.step_fn(self.state, {"latents": latents, "context": context}, self.gen)
        if self.counting:
            self.steps += 1
        return loss

    def gathered(self, captures: list) -> list:
        """The captured steps: one rank holds them all."""
        return captures

    def model_flops(self) -> float:
        """Model operations of the window's steps: the UNet forward and the
        backward to its inputs (the adapter's own products are small), the
        clips' encode and the captions."""
        from benchmark.work import models

        tr, cfg = self.traffic, self.cfg
        f, h, w, c = program.latent_shape(cfg, {"frames": tr["frames"], "height": tr["resolution"],
                                                "width": tr["resolution"]})
        b = tr["batch_size"]
        per_step = (2 * models.unet_call(cfg, (b, f, h, w, c)) + b * models.vae_encode(cfg, f, h, w)
                    + b * models.text_chunk(cfg))
        return self.steps * per_step

    def release(self) -> None:
        self.pipe = self.state = self.step_fn = None
        spans.remove(self.timer.handles + self.annot.handles)
