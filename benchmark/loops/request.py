"""Closed-loop video requests: one client sends the next request when the
last has answered. A traffic file of this loop sets no more than ``KEYS``.

A traffic file of this loop names the entry the client calls:

* ``infer``: one ``infer`` request of the family's pipeline (a web UI or
  API user's video), with a no-op step callback every ``callback_interval``
  steps, as ``run`` passes one;
* ``run``: ``t2v_torch.pipeline.run.run`` with ``batch_count`` videos and
  ``dp_shards`` = ``batch_count`` on one card and no process group: its one
  batched sampling loop (``parallel/dp_sample.py``), then per video the
  decode and the PNG frames under ``$TMPDIR``, with no mp4 (the host has no
  ffmpeg). With ``sp_shards`` above 1 the cell runs one rank a card
  (``benchmark/ranks.py``) and every rank calls ``run`` with that many
  frame shards: each samples its F / sp frames of the one video, the UNet
  gathers them where it mixes frames, and rank 0 decodes and writes.

Request i's prompt and latent seed come from (run seed, i)
(``benchmark/prompts.py``). Set-up warms every shape of the loop with one
short request (``warm_steps`` steps) from another stream of the seed.

While a unit is ``captured`` the loop keeps what the timed path produced,
for ``benchmark/correct/request.py``: each UNet call's input state,
timesteps, text conditioning and output, and each decode's float32 latents
and uint8 frames. Under a frame split each rank keeps its own frames of
every call; ``gathered`` puts them together on rank 0 once the window and
the traced units are over.
"""

from __future__ import annotations

import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from benchmark import program, prompts, spans, spec
from benchmark.reference.text import Tokenizer
from benchmark.work import layers as work

KEYS = frozenset({"why", "loop", "entry", "batch_count", "frames", "height", "width", "steps",
                  "sampler", "eta", "cfg_scale", "n_prompt", "callback_interval", "warm_steps",
                  "trace_units", "prompt", "sp_shards"})


class Capture:
    def __init__(self):
        self.calls: list[dict] = []  # x (rows of the state), t, ctx, out
        self.decodes: list[dict] = []  # latents (F, h, w, C) float32, frames uint8
        self.requests: list[tuple[str, int]] = []  # (prompt, latent seed) of each video


def _attention_work(mod, args, kwargs):
    """Work of one attention module call: self attention, cross attention
    over a context, or (a module with a frame split) temporal attention."""
    x = args[0]
    rows, n, dq = x.shape
    heads, dh, size = mod.heads, mod.dim_head, x.element_size()
    if type(mod).__name__ == "TemporalCrossAttention":
        t = kwargs.get("frame_split") or n
        return work.attention(rows, n, dq, heads, dh, frames=t, itemsize=size)
    ctx = kwargs.get("context", args[1] if len(args) > 1 else None)
    if ctx is None:
        return work.attention(rows, n, dq, heads, dh, itemsize=size)
    return work.attention(rows, n, dq, heads, dh, ctx_rows=ctx.shape[0], s=ctx.shape[1],
                          dc=ctx.shape[2], itemsize=size)


def _temporal_conv_work(mod, args, kwargs):
    """Work of one temporal convolution block: over every frame, which a
    block whose frames are split over sp ranks gathers first."""
    b, f, h, w, c = args[0].shape
    sp = getattr(mod, "sp", None)
    f *= sp.size if sp is not None else 1
    return work.temporal_conv(b, f, h * w, c, itemsize=args[0].element_size())


def videos(traffic: dict, tok: Tokenizer, run_seed: int, i: int) -> list[tuple[str, int]]:
    """(prompt, latent seed) of each video of unit ``i``: one prompt, and the
    seeds seed, seed + 1, ... of its ``batch_count`` videos."""
    p, seed = prompts.request(traffic["prompt"], tok, run_seed, i)
    return [(p, seed + k) for k in range(traffic["batch_count"])]


class Loop:

    def __init__(self, cfg: dict, traffic: dict, run_seed: int, device, peaks: dict | None):
        spec.only_keys(traffic, KEYS, "request")
        self.cfg, self.traffic, self.run_seed, self.device = cfg, traffic, int(run_seed), device
        self.fam = spec.family(cfg)
        self.sp = traffic.get("sp_shards", 1)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.sp != world or (world > 1 and (traffic["entry"] != "run"
                                               or traffic["batch_count"] != 1)):
            raise ValueError(f"the request loop runs sp_shards {self.sp} on {world} rank(s): a "
                             "frame split takes one rank a shard, one video through run")
        self.tok = Tokenizer(cfg["tokenizer"]["merge_words"])
        self.timer = spans.Timer()
        self.annot = spans.Annotator(peaks)
        self.capture: Capture | None = None
        self.setup_captures: list = []
        self.reset()
        self.counting = False  # the window's counters run only inside the window
        self.outdir = tempfile.mkdtemp(prefix="t2v_bench_frames_")  # under $TMPDIR

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        self.pipe = program.build(self.cfg, self.run_seed, self.device)
        unet = self.pipe.unet
        self.timer.watch(unet, "unet_call")
        self.annot.watch(unet, "unet_call")
        spans.hook(unet, self._pre_unet, self._post_unet)
        for mod in unet.modules():
            kind = type(mod).__name__
            if kind in ("CrossAttention", "TemporalCrossAttention"):
                self.annot.watch(mod, "attention", _attention_work)
            elif kind == "TemporalConvBlock":
                self.annot.watch(mod, "temporal_conv", _temporal_conv_work)
        decode = self.pipe.decode_latents

        def decode_latents(latents):
            with self.annot.span("decode"):
                frames = decode(latents)
            if self.capture is not None:
                self.capture.decodes.append({"latents": latents.detach().float().clone(),
                                             "frames": np.array(frames)})
            return frames

        self.pipe.decode_latents = decode_latents
        self.unit(0, warm=True)

    def reset(self) -> None:
        """Zero the window's counters and start counting."""
        self.decode_s: list[float] = []
        self.unet_calls = self.videos = self.requests = 0
        self.counting = True

    def new_capture(self) -> Capture:
        return Capture()

    def model_flops(self) -> float:
        """Model operations of the window's UNet calls, decodes and prompts."""
        from benchmark.work import models

        tr, cfg = self.traffic, self.cfg
        f, h, w, c = program.latent_shape(cfg, tr)
        call = models.unet_call(cfg, (2 * tr["batch_count"], f, h, w, c))
        return (self.unet_calls * call + self.videos * models.vae_decode(cfg, f, h, w)
                + self.requests * models.text_chunk(cfg))

    def _pre_unet(self, mod, args, kwargs):
        self.unet_calls += self.counting
        if self.capture is None:
            return
        x, t = args[0], args[1]
        ctx = args[2] if len(args) > 2 else kwargs.get("context")
        rows = x.shape[0] // 2  # the [uncond; cond] doubled batch: both halves hold the state
        self.capture.calls.append({"x": x[:rows].detach().float().clone(), "t": t.detach().clone(),
                                   "ctx": ctx.detach().clone()})

    def _post_unet(self, mod, args, kwargs, out):
        if self.capture is not None:
            self.capture.calls[-1]["out"] = out.detach().clone()

    # ---------------------------------------------------------------- units

    def args(self, i: int, warm: bool = False):
        from t2v_torch.core.config import T2VArgs

        tr = self.traffic
        p, seed = videos(tr, self.tok, self.run_seed + (1 << 40 if warm else 0), i)[0]
        return T2VArgs(
            prompt=p, n_prompt=tr["n_prompt"], sampler=tr["sampler"],
            steps=tr["warm_steps"] if warm else tr["steps"], frames=tr["frames"], seed=seed,
            cfg_scale=tr["cfg_scale"], width=tr["width"], height=tr["height"], eta=tr["eta"],
            batch_count=tr["batch_count"], model_type=self.fam.MODEL_TYPE)

    def unit(self, i: int, warm: bool = False) -> int:
        """Answer request ``i``; returns the videos completed."""
        tr = self.traffic
        args = self.args(i, warm)
        if self.capture is not None:
            self.capture.requests += videos(tr, self.tok, self.run_seed, i)
        noop = lambda done: None
        if tr["entry"] == "infer":
            res = self.pipe.infer(args, callback=noop, callback_interval=tr["callback_interval"],
                                  **self.fam.INFER_KWARGS)
            if self.counting and not warm:
                self.decode_s.append(res.timings["decode"])
                self.videos += 1
                self.requests += 1
            return 1
        from t2v_torch.core.config import T2VOutputArgs
        from t2v_torch.pipeline.run import run

        out = run(args, T2VOutputArgs(skip_video_creation=True), pipe=self.pipe,
                  outdir=self.outdir, dp_shards=tr["batch_count"], sp_shards=self.sp,
                  callback_interval=tr["callback_interval"],
                  device=str(self.device))
        for d in out.frame_dirs:
            shutil.rmtree(d, ignore_errors=True)
        n = len(out.frame_dirs)
        if self.counting and not warm:
            if n:  # the ranks that decode: a video's share of the request's decodes
                self.decode_s += [out.timings["decode"] / n] * n
            self.videos += n
            self.requests += 1
        return n

    def gathered(self, captures: list) -> list:
        """The captured units with every call's whole state and output: under
        a frame split, every rank's frames of each call in rank order (a
        dp = tp = 1 mesh puts sp index s on rank s), complete on rank 0.
        Collective: every rank calls it with captures of the same calls."""
        if self.sp == 1:
            return captures
        for cap in captures:
            for call in cap.calls:
                for key in ("x", "out"):
                    parts = [torch.empty_like(call[key]) for _ in range(self.sp)]
                    dist.all_gather(parts, call[key].contiguous())
                    call[key] = torch.cat(parts, dim=1)
        return captures

    def release(self) -> None:
        """Drop the program's state (``run`` keeps the last pipeline in a
        module global) and return its memory to the device."""
        self.pipe = None
        run_mod = sys.modules.get("t2v_torch.pipeline.run")
        if run_mod is not None:
            run_mod._warm_pipe = None
        spans.remove(self.timer.handles + self.annot.handles)
        shutil.rmtree(self.outdir, ignore_errors=True)
