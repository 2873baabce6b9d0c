"""Whether what a request loop's timed path produced is correct.

The plain float32 reference (``benchmark/reference``) re-derives everything
from the benchmark's own inputs (the seeded weights, each request's prompt
and latent seed) and judges the captured units of the window:

* ``calls``: UNet calls a request made, against the sampler's plan (exact);
* ``timesteps``: the timestep of every call, against the plan (exact);
* ``start``: the first call's state, against the start latent the reference
  draws from the request's seed (a ``torch.Generator`` on the device, as the
  published pipelines seed theirs; exact);
* ``text``: the text conditioning each call received, against the
  reference's towers on the same prompts, up to one scale a row (relative
  RMS of the best-scaled row, worst row). The scale is the emphasis
  renorm's: it multiplies a chunk by the ratio of its means before and after
  the emphasis, and with random weights those means lie near zero (1e-5 to
  1e-4 against elements of about 1), so the tower's bf16 rounding, a steady
  1.1% of each element, moves the ratio by up to a fifth on some prompts.
  Its gap from the reference's is printed (``notes``), not compared, so no
  number here sees a renorm that is dropped or misapplied;
* ``unet``: at sampled calls, the program's output against the reference
  UNet's on the same state, timestep and conditioning (relative RMS, worst
  row and frame);
* ``step``: from the same state, the reference's guidance and update against
  the state the program went on with (the next call's input, or the
  latents it decoded), relative to the reference's update (worst video);
* ``decode``: the program's frames against the reference decode of the
  latents it decoded (mean absolute difference in levels, worst frame).

The reference follows the program step by step from the program's own
states (the latent and the conditioning its UNet received); ``start`` and
``text`` check where the chain begins and ``step`` each link it samples. The calls sampled are drawn from the run's seed; the last call of
each request is always among them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, prompts
from benchmark.reference import modelscope, sampling, text, vae, videocrafter
from benchmark.reference.ops import Ops, strict_fp32

NAMES = ("calls", "timesteps", "start", "text", "unet", "step", "decode")


def scaled_gap(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(relative RMS of the best-scaled ``got`` against ``want``, |scale - 1|)."""
    got, want = got.float(), want.float()
    scale = float((got * want).sum() / (got * got).sum().clamp_min(1e-30))
    return _rel(scale * got, want), abs(scale - 1.0)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


class Reference:
    """The reference models of one configuration, on the run's weights."""

    def __init__(self, cfg: dict, run_seed: int, device, dtype: torch.dtype, ops: Ops,
                 sd: dict | None = None):
        self.cfg, self.ops, self.device = cfg, ops, device
        self.sd = sd if sd is not None else program.reference_weights(cfg, run_seed, device, dtype)
        self.tok = text.Tokenizer(cfg["tokenizer"]["merge_words"])
        self.ms = cfg["family"] == "modelscope"

    def context(self, prompt: str) -> torch.Tensor:
        fn = text.modelscope_context if self.ms else text.videocrafter_context
        return fn(self.sd["text"], self.cfg["text"], self.tok, prompt, self.ops)

    def unet(self, x, t, ctx) -> torch.Tensor:
        mod = modelscope if self.ms else videocrafter
        return mod.forward(self.sd["unet"], self.cfg["unet"], x, t, ctx, self.ops)

    def decode(self, latents) -> torch.Tensor:
        return vae.decode_frames(self.sd["vae"], self.cfg["vae"], latents,
                                 self.cfg["vae"]["scale_factor"], self.ops)

    def start(self, seed: int, shape) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return torch.randn((1, *shape), generator=gen, device=self.device, dtype=torch.float32)


def sampled_calls(run_seed: int, unit: int, n_calls: int, count: int) -> list[int]:
    """``count`` call indices of a unit drawn from the run's seed, the last
    call among them."""
    rng = prompts.request_rng(run_seed, unit, stream=2)
    others = rng.choice(n_calls - 1, size=min(count - 1, n_calls - 1), replace=False)
    return sorted({int(i) for i in others} | {n_calls - 1})


@torch.no_grad()
def judge(ref: Reference, traffic: dict, captures: list, run_seed: int, calls_per_unit: int) -> dict:
    """The compared numbers over the captured units (worst of each)."""
    sampler = traffic["sampler"]
    plan = sampling.plan(sampler, traffic["steps"])
    worst = dict.fromkeys(NAMES + ("text_scale",), 0.0)
    up = lambda k, v: worst.__setitem__(k, max(worst[k], float(v)))
    for unit, cap in enumerate(captures):
        reqs = cap.requests
        n = len(reqs)
        up("calls", abs(len(cap.calls) - len(plan)))
        if not cap.calls or len(cap.decodes) != n:
            up("calls", max(1, abs(len(cap.decodes) - n)))
            continue
        for call, rung in zip(cap.calls, plan):
            up("timesteps", float((call["t"].float() - rung[0]).abs().max()))
        ctx_u = ref.context(traffic["n_prompt"])
        ctx_c = {p: ref.context(p) for p in dict.fromkeys(p for p, _ in reqs)}
        want_ctx = torch.cat([ctx_u] * n + [ctx_c[p] for p, _ in reqs])
        got_ctx = cap.calls[0]["ctx"]
        for r in range(2 * n):
            gap, scale = scaled_gap(got_ctx[r], want_ctx[r])
            up("text", gap)
            up("text_scale", scale)
        shape = tuple(cap.calls[0]["x"].shape[1:])
        for k, (_, seed) in enumerate(reqs):
            up("start", float((cap.calls[0]["x"][k] - ref.start(seed, shape)[0]).abs().max()))
        final = torch.stack([d["latents"] for d in cap.decodes])
        for i in sampled_calls(run_seed, unit, min(len(cap.calls), len(plan)), calls_per_unit):
            call = cap.calls[i]
            x = call["x"].float()
            t = torch.full((2 * n,), float(plan[i][0]), device=x.device)
            outs = []
            for k in range(n):  # one [uncond; cond] pair at a time
                rows = [k, n + k]
                outs.append(ref.unet(torch.cat([x[k:k + 1]] * 2), t[rows], call["ctx"][rows]))
            got = call["out"].float()
            for k in range(n):
                for r, row in enumerate((k, n + k)):
                    for f in range(got.shape[1]):
                        up("unet", _rel(got[row, f], outs[k][r, f]))
            x_next = cap.calls[i + 1]["x"].float() if i + 1 < len(cap.calls) else final
            for k in range(n):
                eps = sampling.guide(sampler, outs[k], traffic["cfg_scale"])
                want = sampling.step(sampler, x[k:k + 1], eps, plan[i])
                up("step", float((x_next[k:k + 1] - want).norm()
                                 / (want - x[k:k + 1]).norm().clamp_min(1e-30)))
        for d in cap.decodes:
            want = ref.decode(d["latents"].to(ref.device)).cpu().numpy().astype(np.float64)
            got = d["frames"].astype(np.float64)
            up("decode", np.abs(got - want).mean(axis=(1, 2, 3)).max())
    worst["notes"] = {"text_scale": worst.pop("text_scale")}
    return worst


def check(cfg: dict, traffic: dict, captures: list, run_seed: int, device, dtype,
          check_spec: dict) -> dict:
    """Judge the program's captures against the float32 reference."""
    with strict_fp32():
        ref = Reference(cfg, run_seed, device, dtype, Ops())
        return judge(ref, traffic, captures, run_seed, check_spec["calls"])


@torch.no_grad()
def control(cfg: dict, traffic: dict, requests: list, run_seed: int, device, dtype,
            sd: dict | None = None) -> list:
    """The control: the reference with float8 operands put in the program's
    place, answering ``requests`` (a list of units, each a list of (prompt,
    latent seed) videos) with its own chain. Returns captures in the
    loop's format, for ``judge``."""
    from benchmark.loops.request import Capture

    sampler = traffic["sampler"]
    plan = sampling.plan(sampler, traffic["steps"])
    out = []
    with strict_fp32():
        ctl = Reference(cfg, run_seed, device, dtype, Ops(fp8=True), sd)
        shape = program.latent_shape(cfg, traffic)
        for reqs in requests:
            cap = Capture()
            cap.requests = list(reqs)
            n = len(reqs)
            ctx = torch.cat([ctl.context(traffic["n_prompt"])] * n + [ctl.context(p) for p, _ in reqs])
            x = torch.cat([ctl.start(seed, shape) for _, seed in reqs])
            for rung in plan:
                t = torch.full((2 * n,), float(rung[0]), device=x.device)
                pairs = [ctl.unet(torch.cat([x[k:k + 1]] * 2), t[[k, n + k]], ctx[[k, n + k]])
                         for k in range(n)]
                res = torch.empty((2 * n, *pairs[0].shape[1:]), device=x.device)
                for k, o in enumerate(pairs):
                    res[k], res[n + k] = o[0], o[1]
                cap.calls.append({"x": x.clone(), "t": t, "ctx": ctx, "out": res})
                x = torch.cat([sampling.step(sampler, x[k:k + 1], sampling.guide(sampler, pairs[k],
                               traffic["cfg_scale"]), rung) for k in range(n)])
            for k in range(n):
                cap.decodes.append({"latents": x[k].clone(), "frames": ctl.decode(x[k]).cpu().numpy()})
            out.append(cap)
    return out
