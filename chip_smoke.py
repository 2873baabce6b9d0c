#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``t2v_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. build every CUDA kernel from ``t2v_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time, and the
   registers, spills and stack of every entry function of the redesigned
   sources (``temporal_conv.cu``, ``fused_mha.cu``, ``flash_attention.cu``,
   ``flash_attention_bwd.cu``, ``relpos_mha.cu``);
2. check that each wrapper refuses malformed CUDA tensors, then hold each
   kernel against its plain PyTorch version on the card, in bf16, at every
   shape the driven paths give it (24-, 125- and 250-frame ModelScope,
   16-frame VideoCrafter, the 16-frame training steps' flash backward) plus
   ragged ones; print the max error against the
   stated tolerance and the kernel's, the plain version's and, where one
   PyTorch call computes the same function, that library call's time (timed
   here as a yardstick only: the port never calls it), with the rate
   reached, the share of the bound, the per-shape plan of the redesigned
   kernels, their times before the redesign, and the temporal-conv layer's
   split into activation pass and GEMM and the flash (forward and both
   backward), cross-attention and rel-pos kernels' device time (torch.profiler),
   with the wrappers' host time; every kernel's device time at its dominant
   shape goes beside its CUDA-event time into the JSON line (``device_ms``);
   the flash backward's two launches at each training-path shape must give
   bit-identical gradients;
3. answer one request with a small ModelScope pipeline and one with a small
   VideoCrafter pipeline whose widths every kernel takes, in bf16 on the
   card, and hold their latents and frames against the same weights in
   float32 on the CPU (``check_small_pipeline``, ``check_small_vc_pipeline``);
   then the same two pipelines built in float32 on the card, which the
   dispatch routes to the plain versions: no kernel launch, and their
   latents and frames match the float32 CPU run (``check_fp32_pipelines``);
4. build ``ModelScopePipeline.random_init`` at the full configs (1.41B-
   parameter UNet, ViT-H text tower, SD VAE) in bf16 on the card, perturb
   the zero-initialised leaves, and answer two txt2vid requests (24 frames
   at 256x256, 20 DDIM_Gaussian steps, CFG 9) and one 125-frame request
   (256x256, 4 steps, CFG 9). For each, print the seconds per phase, the
   peak memory, the frames' shape, dtype and finiteness, and each kernel's
   launch count, which must equal the count the UNet topology predicts;
   time one 24-frame UNet call and break its device time down by kernel
   category with torch.profiler;
5. the same with ``VideoCrafterPipeline.random_init`` at full width (CLIP-L
   tower, 8-head UNet with relative-position temporal attention, SD VAE):
   two requests (16 frames at 256x256, 20 DDIM steps, CFG 9), counted
   launches, and the breakdown of one UNet call. No plain version of a
   kernel may run on a CUDA tensor in phases 4 to 8;
6. ModelScope from a model directory to an mp4 (``drive_generate``): a
   full-width directory in the published layout (``configuration.json``,
   float32 ``text2video_pytorch_model.pth``, ``VQGAN_autoencoder.pth``
   under ``state_dict``, ``open_clip_pytorch_model.bin`` with the published
   49,408-row embedding, the repo's test vocab under the published name)
   written from a seeded bf16 pipeline into a temporary directory, loaded by
   ``load_pipeline`` with every parameter bit-identical; one 24-frame
   request each from the source pipeline, the loaded one, ``cli.generate``
   and the stdlib API server on 127.0.0.1 (identical frames, launch
   counts); a 'Main Model Only' pair through ``run`` (``release_aux``
   frees at least the VAE's and text tower's bytes, the reloaded request's
   frames are identical); the write, load, CLI, API and release numbers;
7. the ModelScope request modes (``drive_modes``), on a second full-width
   ModelScope pipeline: first TPU rows 9 and 10, which no model calls, on
   the activations of one 24-frame UNet call (forward hooks capture the q/k/v
   of its 34 temporal self-attentions and the projections of its 33 GEGLU
   sites; ``temporal_attention_packed`` and ``geglu`` run on each capture
   and are held against the model's own route and the plain versions);
   then UniPC, DPM++ 2M Karras and Euler a requests, vid2vid with
   DDIM_Gaussian and DDIM, progressive inpainting, an exact request and the
   same with DeepCache interval 2 (PSNR printed), the same windowed by a
   callback every 5 steps (bit-identical latents), and one its callback
   interrupts; every launch count against the topology's;
8. training, on the pipelines of phases 4 and 5: hold the gradients of the
   seven kernel ``autograd.Function``s against autograd through the plain
   versions at one training-path shape each; hold one small LoRA training
   step in bf16 on the card (loss and gradients) against float32 on the
   CPU; then train at full width on synthetic clips from a seed (batch 1 x
   16 frames at 256x256, clips through ``compute_latents``, captions through
   the text tower): ModelScope LoRA rank 4 for 3 steps, ModelScope full
   fine-tune with EMA 0.9999 for 2, VideoCrafter full fine-tune for 2. For
   each, every loss is finite, the trained leaves moved, the pipeline's own
   weights did not, the EMA follows its rule, and the launch counts equal
   the topology's (5 flash backward pairs per step); print seconds per
   step, peak memory, and one profiled step's device time and idle share;
9. VideoCrafter's other branches (``drive_vcbranches``): the DDPM chain on
   the small pipeline (bf16 on the card against float32 on the CPU, step by
   step), a tiny MidasSmall and Adapter likewise, one masked
   temporal-attention call (plain on the card, no rel-pos launch); then at
   full width the ``uc_type`` variants, DPM++ 2M whole and windowed
   (bit-identical), LVDM mask inpainting through ``run`` (the kept frame
   holds the source), an FPS-conditioned ``model.ckpt`` through
   ``load_vc_pipeline`` (8 and 24 frames a second differ, none raises), and
   the depth adapter with MiDaS from files through ``run`` and the CLI;
   every request's launches against the topology's;
10. sharded sampling (``drive_parallel``), both models at full width: two
    serial batches through ``run`` and the same request with
    ``dp_shards=2`` in one process (one batched loop; its first, middle and
    last UNet calls against the serial calls on the same rows, its frames
    by relative RMS, a planted fault in the batch caught by that frame
    gate); two ranks this script starts (``--parallel-rank``)
    sharing the card over gloo: dp = 2 frames bit-identical to the serial
    ones, tp = 2 and sp = 2 UNet calls against the one-rank call on the
    same inputs, every request's launches a rank against the topology's
    and its collectives (``parallel/audit.py``) against the port's model:
    one line per mesh axis and kind, calls and bytes;
    then ``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m t2v_torch.cli.generate --dp-shards 2`` on a directory saved from
    the serial pipeline (rank 0 writes both batches once, bit-identical);
11. training over a mesh (``drive_meshtrain``): the attention Functions'
    gradients at the tp- and sp-local shapes (``check_mesh_gradients``,
    also in ``--only kernels``); the legacy blocks at UNetSD's widths (the
    attention block's flash call against its plain version on its own
    inputs, the residual block in bf16 against float32 on the CPU); two
    ranks this script starts (``--meshtrain-rank``) sharing the card over
    gloo train both full-width models in bf16 on seeded clips (batch x 16
    frames at 256x256): ModelScope LoRA rank 4 at dp = 2, tp = 2 and
    sp = 2, ModelScope full with EMA 0.9999 at dp = 2, VideoCrafter full
    at tp = 2 and sp = 2, two steps each; each case's first step (loss and
    every gathered gradient leaf) against the one-rank step on the same
    inputs and draw, two planted faults that gradient gate must catch and
    two (a rank on the wrong share) that it or the loss gate must, the
    trained leaves moved and the pipeline's not, launches a rank against
    the topology's, seconds a step, peak memory, and the collectives of
    the steps against the port's model (one line per axis and kind, calls
    and bytes; all-reduced and all-gathered bytes a step), with a planted
    per-call weight gather that passes the numeric gates and that the
    audit must catch; then the trainer CLI's ``main`` (``t2v_torch.cli.train
    --model-type VideoCrafter --sp 2``) under ``python -m
    torch.distributed.run --standalone --nproc-per-node 2`` for two steps
    and ``--resume`` to a third, the plain versions barred and each rank's
    launches held against the topology's, its first step's loss and
    gradients against one process's on the same clips and seed (rank 0
    writes each
    ``step_N/`` once; the first loads through ``from_model_dir`` at the
    full shapes);
12. print the card's name and power limit, one ``{"kernels": [...]}`` line,
    and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a GPU, and in a directory without the port.
``--only kernels|small|modelscope|generate|modes|videocrafter|vcgenerate|vcbranches|parallel|train|meshtrain``
runs the build and those groups of phases (a comma-separated list, for work
on one of them; it prints no result line); ``--only vcddpm`` answers the
full-width DDPM request (1,000 steps), which the default run leaves out.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# a kernel agrees with its plain version when its max abs error is within
# this share of the largest |output|: about 2.5 bf16 ulps there. Both round
# at the same points; they differ in f32 summation order, which can flip
# one bf16 rounding, and such flips carry through the chain's four layers
TOL_SHARE = 0.02

T = 24            # frames of the ModelScope request
T_LONG = 125      # frames of the long ModelScope request
PX = 256          # width and height of every request
LAT = 32          # 256 px / 8
STEPS = 20
STEPS_LONG = 4
CFG = 9.0
VC_T = 16         # frames of the VideoCrafter request
VC_STEPS = 20

# Shapes each kernel is held against its plain version at (the CPU tests of
# the kernels' plans read these lists too).
# Temporal conv (B, F, HW, C): the four UNet levels at 24 frames with CFG,
# a ragged one (checked, not timed); then the long videos, for which the
# TPU package has a second, frame-chunked kernel: the 125-frame request's
# levels, every 250-frame level, and a ragged one
CONV_RAGGED = (1, 5, 37, 128)
CONV_SHAPES = [(2, T, 1024, 320), (2, T, 256, 640), (2, T, 64, 1280), (2, T, 16, 1280),
               CONV_RAGGED]
CONV_LONG_SHAPES = [(2, T_LONG, 1024, 320), (2, T_LONG, 256, 640), (2, T_LONG, 64, 1280),
                    (2, T_LONG, 16, 1280), (2, 250, 1024, 320), (2, 250, 256, 640),
                    (2, 250, 64, 1280), (2, 250, 16, 1280), (1, 131, 9, 64)]
# Packed self-attention (B, N, heads, D). ModelScope (D = 64): spatial
# self-attention at 16x16, 8x8 and 4x4 (2 x 24 and 2 x 125 frames), temporal
# self-attention over 24 and 125 frames at every level and over 250 at the
# 32x32 and 8x8 ones; VideoCrafter (8 heads, D = 80 and 160): spatial
# self-attention at 16x16, 8x8 and 4x4; ragged ones at every head dim, and
# two whose K/V exceed shared memory and stream (D = 160, 450 keys)
SELF_MHA_RAGGED = [(7, 13, 3, 64), (3, 50, 2, 40), (7, 13, 3, 80), (5, 29, 2, 160),
                   (2, 450, 2, 160), (132, 450, 2, 160)]
SELF_MHA_CASES = [(48, 256, 10, 64), (48, 64, 20, 64), (48, 16, 20, 64), (2048, 24, 5, 64),
                  (2048, 24, 8, 64), (512, 24, 10, 64), (128, 24, 20, 64), (32, 24, 20, 64),
                  (250, 256, 10, 64), (250, 64, 20, 64), (250, 16, 20, 64),
                  (2048, 125, 5, 64), (2048, 125, 8, 64), (512, 125, 10, 64), (128, 125, 20, 64),
                  (32, 125, 20, 64), (2048, 250, 5, 64), (128, 250, 20, 64),
                  (32, 256, 8, 80), (32, 64, 8, 160), (32, 16, 8, 160), *SELF_MHA_RAGGED]
# the same sites on one rank of the sharded paths (two ranks): tp = 2 halves
# every head count that divides (ModelScope's 5-head level stays whole),
# sp = 2 halves the frames of the spatial sites (the temporal ones see every
# frame). ModelScope tp: spatial at 16x16, 8x8, 4x4, temporal at the four
# levels; ModelScope sp: spatial; VideoCrafter tp and sp: spatial
SELF_MHA_SHARDED = [(48, 256, 5, 64), (48, 64, 10, 64), (48, 16, 10, 64), (2048, 24, 4, 64),
                    (512, 24, 5, 64), (128, 24, 10, 64), (32, 24, 10, 64),
                    (24, 256, 10, 64), (24, 64, 20, 64), (24, 16, 20, 64),
                    (32, 256, 4, 80), (32, 64, 4, 160), (32, 16, 4, 160),
                    (16, 256, 8, 80), (16, 64, 8, 160), (16, 16, 8, 160)]
SELF_MHA_CASES += SELF_MHA_SHARDED
# Packed cross-attention (B, N, S, heads, D), all on the packed kernel's
# body: VideoCrafter's spatial cross-attention, 16 frames of tokens merged
# into the query rows over the 77-token context, at its four levels; a
# ragged one; and a longer context
CROSS_MHA_RAGGED = [(3, 1000, 50, 5, 40), (2, 300, 200, 2, 64)]
CROSS_MHA_CASES = [(2, 16384, 77, 8, 40), (2, 4096, 77, 8, 80), (2, 1024, 77, 8, 160),
                   (2, 256, 77, 8, 160), *CROSS_MHA_RAGGED]
# one rank of VideoCrafter's sharded paths: tp = 2 (4 heads), sp = 2 (8 frames)
CROSS_MHA_SHARDED = [(2, 16384, 77, 4, 40), (2, 4096, 77, 4, 80), (2, 1024, 77, 4, 160),
                     (2, 256, 77, 4, 160), (2, 8192, 77, 8, 40), (2, 2048, 77, 8, 80),
                     (2, 512, 77, 8, 160), (2, 128, 77, 8, 160)]
CROSS_MHA_CASES += CROSS_MHA_SHARDED
# Frame-axis attention (B samples, F frames, N tokens, heads, D): every
# ModelScope level at 24, 125 and 250 frames (CFG batch 2, 64-wide heads),
# the 1024x576 top level (72x128 latent), and ragged ones at the other
# head dims
TEMPORAL_MHA_RAGGED = [(2, 5, 7, 3, 40), (2, 5, 7, 2, 80), (2, 5, 7, 2, 160),
                       (1, 37, 13, 2, 64)]
TEMPORAL_MHA_CASES = [(2, f, n, h, 64) for f in (T, T_LONG, 250)
                      for n, h in ((1024, 5), (256, 10), (64, 20), (16, 20))]
TEMPORAL_MHA_CASES += [(2, T, 9216, 5, 64), *TEMPORAL_MHA_RAGGED]

# Flash attention forward (B, N, S, D, scale): ModelScope's 32x32 spatial
# self-attention at 24 frames (2 x 24 x 5 heads) and at 125 frames,
# VideoCrafter's at 40-wide heads (2 x 16 x 8), the VAE mid-block attention
# (one head of 512) at 256x256 and, on 12-frame chunks, on the tiled
# decode's 64 x 64 tiles and untiled at ZeroScope's 72 x 128 latent, then
# ragged ones that reach the edges of the kernel's tiles (128 query rows,
# 64 at D = 512; 128 or 64 keys): N and S not multiples of a tile, S
# shorter than one key tile, a single query row, D = 80 and 160, and
# N != S at D = 512
FLASH_TIMED = [(240, 1024, 1024, 64, 0.125), (1250, 1024, 1024, 64, 0.125),
               (256, 1024, 1024, 40, 40 ** -0.5), (24, 1024, 1024, 512, 512 ** -0.5),
               (12, 4096, 4096, 512, 512 ** -0.5), (12, 9216, 9216, 512, 512 ** -0.5)]
FLASH_RAGGED = [(3, 333, 777, 64, 0.125), (3, 333, 777, 40, 40 ** -0.5), (2, 70, 600, 160, 0.1),
                (2, 200, 50, 64, 0.125), (2, 130, 100, 40, 40 ** -0.5), (2, 1, 513, 64, 0.125),
                (2, 300, 517, 80, 80 ** -0.5), (3, 129, 65, 160, 160 ** -0.5),
                (2, 100, 300, 512, 512 ** -0.5), (1, 65, 1030, 512, 512 ** -0.5)]
# one rank of the sharded paths: ModelScope sp = 2 (12 frames of 5 heads; its
# 5-head level stays whole under tp), VideoCrafter tp = 2 (4 heads) or sp = 2
# (8 frames): both (128, 1024, 1024, 40)
FLASH_SHARDED = [(120, 1024, 1024, 64, 0.125), (128, 1024, 1024, 40, 40 ** -0.5)]
FLASH_CASES = FLASH_TIMED + FLASH_RAGGED + FLASH_SHARDED

# samples per training step of the full-width runs: the batch that the
# flash backward's path shapes are sized by
TRAIN_B = 1
TRAIN_T = 16      # frames of a training clip
# Flash backward (B, N, S, D, scale): the 32x32 spatial self-attention of
# one training step (TRAIN_B x 16 frames x 5 heads of 64 for ModelScope, x 8
# heads of 40 for VideoCrafter: the two path shapes), the other head dims,
# then ragged ones at the edges of the kernels' tiles (dkv: 128-key blocks
# up to D = 64, 64-key ones above, 64-query tiles; dq: 128-row query
# blocks, 64-key tiles): N and S off the tiles at D = 40, 64 and 80, S
# under one key tile, a single query row, and N != S at D = 160
FLASH_BWD_PATH = [(80 * TRAIN_B, 1024, 1024, 64, 0.125),
                  (128 * TRAIN_B, 1024, 1024, 40, 40 ** -0.5)]
FLASH_BWD_RAGGED = [(3, 333, 777, 64, 0.125), (3, 333, 777, 40, 40 ** -0.5),
                    (2, 70, 600, 160, 0.1), (2, 600, 70, 80, 80 ** -0.5),
                    (2, 191, 129, 40, 40 ** -0.5), (2, 65, 257, 80, 80 ** -0.5),
                    (2, 200, 50, 64, 0.125), (2, 130, 30, 80, 80 ** -0.5),
                    (2, 1, 513, 64, 0.125), (2, 1, 300, 40, 40 ** -0.5),
                    (3, 129, 65, 160, 160 ** -0.5)]
FLASH_BWD_CASES = (FLASH_BWD_PATH + [(32, 1024, 1024, 80, 80 ** -0.5),
                                     (16, 1024, 1024, 160, 160 ** -0.5)] + FLASH_BWD_RAGGED)

# Rel-pos temporal attention (B, T, N, heads, D): VideoCrafter's temporal
# attention over 16 frames at its four levels (CFG batch 2; timed), then
# ragged ones (checked, not timed): 5, 24, 40 and 64 frames (one to four
# 16-frame tiles, keys masked past T), head dims 16, 24 and 160 (columns
# past D read as zeros), token counts that leave a tile's last run short,
# tiles of 15 pairs, and K2/V2 staged in shared memory at 5 and 24 frames
# as well as read from device memory
RELPOS_PATH = [(2, 16, 1024, 8, 40), (2, 16, 256, 8, 80), (2, 16, 64, 8, 160),
               (2, 16, 16, 8, 160)]
RELPOS_RAGGED = [(2, 5, 37, 3, 24), (2, 24, 8, 2, 40), (1, 40, 6, 2, 160), (2, 16, 1023, 8, 40),
                 (1, 64, 5, 2, 160), (2, 5, 4096, 3, 24), (2, 24, 4096, 1, 16)]
# one rank of VideoCrafter's tp = 2 path (4 heads; sp gathers all 16 frames
# first, so its shapes are the path's)
RELPOS_SHARDED = [(2, 16, 1024, 4, 40), (2, 16, 256, 4, 80), (2, 16, 64, 4, 160),
                  (2, 16, 16, 4, 160)]
RELPOS_CASES = RELPOS_PATH + RELPOS_RAGGED + RELPOS_SHARDED

# the time of each redesigned kernel at its dominant shape before its
# redesign (PERF.md section 6, measured on an "NVIDIA H100 80GB HBM3,
# 700.00 W"), printed beside this run's
BEFORE_REDESIGN_MS = {"temporal_conv": 0.6516, "temporal_conv_long": 3.1702,
                      "fused_self_mha": 0.3901, "fused_temporal_mha": 0.2294,
                      "flash_attention": 1.1703, "flash_attention_vae": 3.1513,
                      "fused_cross_mha": 0.1772, "flash_bwd_dkv": 1.5542, "flash_bwd_dq": 0.6499,
                      "relpos_mha": 0.1874, "relpos_mha (32, 256, 640, 8)": 0.1277,
                      "relpos_mha (32, 64, 1280, 8)": 0.1054,
                      "relpos_mha (32, 16, 1280, 8)": 0.0589}
# the rel-pos wrapper's host time a call before its redesign, least and
# most over its four runs at the dominant shape (us; that wrapper bound its
# C entry and the entry queried the device on every call): tools/relpos_ab.py
# on the parent tree, "NVIDIA H100 80GB HBM3, 700.00 W"
RELPOS_HOST_US_BEFORE = (31.2, 50.6)


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _release() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


class KernelRecord:
    def __init__(self, name, source, replaces, path, counter=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.path = path  # the driven path whose launches the JSON line reports
        self.counter = counter or name  # the wrapper's launch count it reads
        self.max_abs_err = 0.0
        self.main = None  # timings at that path's dominant shape

    def timed(self, shape, ms, plain_ms, library_ms, flops, nbytes, main=False, plan="",
              before_key=None, device_ms=None) -> None:
        """Print one launch's time at ``shape`` (CUDA events around the
        wrapper, and ``device_ms``, the kernels' device time by
        torch.profiler, where measured) beside its bound, the plain
        version's and the library call's (None: no PyTorch call computes the
        function), the rate it reached in the bound's unit and its share of
        the bound, and at the dominant shape of a redesigned kernel (or at
        the shape ``before_key`` names) its time before the redesign; keep
        it for the JSON line when it is the dominant shape (a device time of
        0, which the profiler did not record, is kept as None)."""
        bound, by = _bound_ms(flops, nbytes)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if by == "operations"
                else f"{nbytes / ms / 1e9:.3f} TB/s")
        before = BEFORE_REDESIGN_MS.get(before_key or self.name) if main or before_key else None
        dev = f", device {device_ms:.4f} ms" if device_ms else ""
        print(f"  time {self.name:18s} {str(tuple(shape)):26s} kernel {ms:.4f} ms{dev}, plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {bound:.4f} ms ({by}); {rate}, "
              f"{100 * bound / ms:.1f}% of the bound"
              + (f"; before the redesign {before:.4f} ms ({before / ms:.2f}x)" if before else "")
              + (f"; plan {plan}" if plan else ""), flush=True)
        if main:
            self.main = {"ms": ms, "device_ms": device_ms or None, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                         "shape": list(shape)}

    def as_json(self, launches: dict) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches[self.path][self.counter],
                "max_abs_err": self.max_abs_err, **self.main, "path": self.path,
                "launches_by_path": {p: c[self.counter] for p, c in launches.items()}}


def _compare(rec: KernelRecord, label: str, got, want) -> None:
    import torch

    if not torch.isfinite(got).all():
        _fail(f"{rec.name} {label}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    rel = err / scale
    ok = err <= TOL_SHARE * scale
    print(f"  {rec.name:18s} {label:38s} max_abs_err={err:.3e} rel={rel:.3e} "
          f"tol={TOL_SHARE * scale:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        _fail(f"{rec.name} {label}: max abs error {err} above {TOL_SHARE * scale}")
    rec.max_abs_err = max(rec.max_abs_err, err)


# one bf16 rounding step is at most this share of the value it rounds to
BF16_STEP = 2.0 ** -7


def _compare_steps(rec: KernelRecord, label: str, got, want, steps: int) -> None:
    """Element by element: every value of ``got`` within ``steps`` bf16
    rounding steps of ``want`` (|got - want| <= steps * 2^-7 * |want| + 1e-6;
    the 1e-6 covers values where both formulas cancel in 1 + erf). For an
    elementwise function, whose outputs span orders of magnitude, where a
    limit scaled by the largest |output| would pass wrong small values."""
    import torch

    if not torch.isfinite(got).all():
        _fail(f"{rec.name} {label}: kernel output is not finite")
    diff = (got.float() - want.float()).abs()
    limit = steps * BF16_STEP * want.float().abs() + 1e-6
    bad = int((diff > limit).sum().item())
    err, worst = diff.max().item(), (diff / limit).max().item()
    print(f"  {rec.name:18s} {label:38s} max_abs_err={err:.3e} "
          f"differing={int((diff > 0).sum().item())}/{diff.numel()} "
          f"worst/limit={worst:.3f} (limit {steps} bf16 step) {'ok' if not bad else 'MISMATCH'}",
          flush=True)
    if bad:
        _fail(f"{rec.name} {label}: {bad} values more than {steps} bf16 steps from the reference")
    rec.max_abs_err = max(rec.max_abs_err, err)


def _chain_layers(g, c, n=4):
    import torch

    dev = "cuda"
    return [(
        1.0 + 0.1 * torch.randn((c,), generator=g, device=dev),
        0.1 * torch.randn((c,), generator=g, device=dev),
        (torch.randn((3, c, c), generator=g, device=dev) / math.sqrt(3 * c)).to(torch.bfloat16),
        (0.1 * torch.randn((c,), generator=g, device=dev)).to(torch.bfloat16),
    ) for _ in range(n)]


def _time_temporal_layer(rec, tc, x, layer, main) -> None:
    """One stats-emitting layer (three of every four launches) on the route
    the chain takes (the raw sums of the layer input, finalised in the
    kernel) beside its plain version; the library yardstick is one matmul
    of the pre-activated, frame-shifted input (B*F*HW, 3C) by the stacked
    taps (3C, C)."""
    import torch

    b, f, hw, c = x.shape
    raw = tc.input_stats(x)
    fin = tc.finalize_stats(raw, f * hw, 1e-5)
    s, bias, w, cb = layer
    call = lambda: tc.temporal_conv_layer(x, raw, s, bias, w, cb, raw_eps=1e-5)  # noqa: E731
    ms = _time_ms(call, 10)
    plain_ms = _time_ms(lambda: tc.layer_plain(x, fin, s, bias, w, cb), 3)
    a = torch.cat([
        torch.nn.functional.silu(
            (x[:, f0:f0 + 25].float() - fin[:, 0, None, None]) * fin[:, 1, None, None]
        ).to(torch.bfloat16) for f0 in range(0, f, 25)], dim=1)
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 1, 1))
    a_cat = torch.cat([a[:, k:k + f] for k in range(3)], dim=-1).reshape(-1, 3 * c)
    del a
    w_cat = w.reshape(3 * c, c)
    lib_ms = _time_ms(lambda: torch.matmul(a_cat, w_cat), 10)
    m = b * f * hw
    p = tc.layer_plan(b, f, hw, c)
    rec.timed((b, f, hw, c), ms, plain_ms, lib_ms, 2.0 * m * 3 * c * c,
              2 * m * c * 2 + 3 * c * c * 2, main=main,
              plan=f"tile {p.bm}x{p.bn} (last column tile {p.last_cols}), {p.stages} stages, "
                   f"{p.smem_bytes} B, {p.blocks} blocks",
              device_ms=_kernel_device_ms(call, "temporal_conv_") if main else None)
    if main:
        _split_temporal_layer(rec, x, call, 2.0 * m * 3 * c * c)


def _host_us(fn, calls: int) -> float:
    """Microseconds of host time a call of ``fn`` takes to return, with the
    card's queue not yet full."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / calls


def _split_temporal_layer(rec, x, call, flops) -> None:
    """The device time of the layer call's three kernels (activation pass,
    GEMM, statistics sum), from torch.profiler over five calls, and the
    host time of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    host = _host_us(call, 20)
    kernels = [(dev_ms / 5, name) for dev_ms, _, name in _device_kernels(prof)]
    act = sum(t for t, name in kernels if "temporal_conv_act_kernel" in name)
    gemm = sum(t for t, name in kernels if "temporal_conv_gemm_kernel" in name)
    stats = sum(t for t, name in kernels if "temporal_conv_stats_kernel" in name)
    total = act + gemm + stats
    if total == 0:
        print(f"  split {rec.name}: the profiler recorded no device time (not measured); "
              f"host {host:.1f} us a call")
        return
    print(f"  split {rec.name:17s} {str(tuple(x.shape)):26s} activation pass {act:.4f} ms "
          f"({100 * act / total:.1f}% of the layer's kernels), GEMM {gemm:.4f} ms "
          f"({flops / gemm / 1e9:.1f} TFLOP/s), statistics sum {stats:.4f} ms: "
          f"{total:.4f} ms of device time (torch.profiler); host {host:.1f} us a call",
          flush=True)


def check_temporal_conv(g) -> list[KernelRecord]:
    import torch

    from t2v_torch.kernels import temporal_conv as tc

    rec = KernelRecord("temporal_conv", "t2v_torch/csrc/temporal_conv.cu",
                       "t2v/kernels/temporal_conv.py:197", "modelscope_24f")
    dev = "cuda"
    for b, f, hw, c in CONV_SHAPES:
        x = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        layers = _chain_layers(g, c)
        got = tc.temporal_conv_chain(x, layers)
        want = tc.chain_plain(x, layers)
        torch.cuda.synchronize()
        _compare(rec, f"chain x{tuple(x.shape)}", got, want)
        if (b, f, hw, c) != CONV_RAGGED:  # the ragged one is checked, not timed
            _time_temporal_layer(rec, tc, x, layers[0], main=(hw, c) == (1024, 320))

    # the long videos: the whole chain (the route the UNet runs, statistics
    # carried as raw sums and finalised in the kernel) against chain_plain;
    # a stats-emitting layer on finalised statistics (output and emitted
    # statistics) and the residual layer, each against layer_plain on the
    # same inputs
    long = KernelRecord("temporal_conv_long", "t2v_torch/csrc/temporal_conv.cu",
                        "t2v/kernels/temporal_conv.py:254", "modelscope_125f",
                        counter="temporal_conv")
    for b, f, hw, c in CONV_LONG_SHAPES:
        x = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        layers = _chain_layers(g, c)
        got = tc.temporal_conv_chain(x, layers)
        want = tc.chain_plain(x, layers)
        torch.cuda.synchronize()
        _compare(long, f"chain x{tuple(x.shape)}", got, want)
        del got, want
        layer = layers[0]
        fin = tc.finalize_stats(tc.input_stats(x), f * hw, 1e-5)
        got, raw = tc.temporal_conv_layer(x, fin, *layer)
        want, raw_want = tc.layer_plain(x, fin, *layer)
        _compare(long, f"stats layer x{tuple(x.shape)}", got, want)
        # the per-channel sums of F*HW bf16 values: compared in units of the
        # count, which keeps one flipped rounding per value inside TOL_SHARE
        _compare(long, f"emitted stats x{tuple(x.shape)}", raw / (f * hw), raw_want / (f * hw))
        del want, raw_want
        res = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        got, _ = tc.temporal_conv_layer(x, fin, *layer, residual=res, emit_stats=False)
        want, _ = tc.layer_plain(x, fin, *layer, residual=res, emit_stats=False)
        torch.cuda.synchronize()
        _compare(long, f"residual layer x{tuple(x.shape)}", got, want)
        del got, want, res
        if c >= 320:  # the ragged one is checked, not timed
            _time_temporal_layer(long, tc, x, layer, main=(f, hw) == (T_LONG, 1024))
        del x
        _release()
    return [rec, long]


def _attn_flops_bytes(b, n, s, d, heads=1):
    return 4.0 * b * heads * n * s * d, 2.0 * b * heads * d * (2 * n + 2 * s)


def _kernel_device_ms(call, kernel: str, calls: int = 5) -> float:
    """Device time a call of ``call`` spends in kernels whose name holds
    ``kernel``, from torch.profiler over ``calls`` calls (0: the profiler
    recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return sum(dev_ms for dev_ms, _, name in _device_kernels(prof) if kernel in name) / calls


def check_flash(g) -> list[KernelRecord]:
    """Row 2 at every ``FLASH_CASES`` shape, both routes: the serving
    forward (output only) and the training forward (output and lse), each
    against ``flash_attention_fwd_plain``. The four path shapes are timed
    beside the plain version and SDPA, with the kernel's device time
    (torch.profiler) and the wrapper's host time a call."""
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_plain,
        flash_plan,
    )

    rec = KernelRecord("flash_attention", "t2v_torch/csrc/flash_attention.cu",
                       "t2v/kernels/flash_attention.py:33", "modelscope_24f")
    for b, n, s, d, scale in FLASH_CASES:
        q = torch.randn((b, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        label = f"q{(b, n, d)} kv{(b, s, d)}"
        want, lse_want = flash_attention_fwd_plain(q, k, v, scale)
        got = flash_attention(q, k, v, scale)
        got_fwd, lse = flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        _compare(rec, label, got, want)
        _compare(rec, f"training forward {label}", got_fwd, want)
        _compare(rec, f"lse {label}", lse, lse_want)
        del got, got_fwd, want, lse, lse_want
        p = flash_plan(b, n, s, d)
        plan = (f"{p.bq} x {p.bkv} tiles{' (column split)' if p.column_split else ''}, "
                f"{p.stages} stages, {p.smem_bytes} B, {p.blocks} blocks")
        if (b, n, s, d, scale) in FLASH_RAGGED:  # checked, not timed
            print(f"    plan {label}: {plan}", flush=True)
            continue
        call = lambda: flash_attention(q, k, v, scale)  # noqa: E731
        ms = _time_ms(call, 10)
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale), 3)
        # SDPA takes its fused paths on 4-D (batch, heads, seq, dim) input
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), 10)
        dev = _kernel_device_ms(call, "flash_fwd_kernel")
        rec.timed((b, n, s, d), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, s, d),
                  main=(b, d) == (240, 64), plan=plan,
                  before_key="flash_attention_vae" if (b, d) == (24, 512) else None,
                  device_ms=dev)
        flops = _attn_flops_bytes(b, n, s, d)[0]
        print(f"  device flash_attention {str((b, n, s, d)):26s} "
              + (f"{dev:.4f} ms ({flops / dev / 1e9:.1f} TFLOP/s; torch.profiler)" if dev
                 else "not measured (the profiler recorded no device time)")
              + f"; host {_host_us(call, 20):.1f} us a call", flush=True)
        _release()
    return [rec]


def _bwd_plan_note(p) -> tuple[str, str]:
    dkv = (f"{p.dkv_bkv} keys x {p.dkv_bq}-query tiles"
           f"{' (dV / dK split)' if p.split else ''}, {p.dkv_stages} stages, "
           f"{p.dkv_smem_bytes} B, {p.dkv_blocks} blocks")
    dq = (f"{p.dq_bq} rows x {p.dq_bkv}-key tiles, {p.dq_stages} stages, "
          f"{p.dq_smem_bytes} B, {p.dq_blocks} blocks")
    return dkv, dq


def _sdpa_bwd_yardstick(q, k, v, do, scale) -> float:
    """Device time of the whole backward (dq, dk and dv) of one
    scaled_dot_product_attention pinned to its flash backend, from
    torch.profiler over the kernels that ``torch.autograd.grad`` launches
    (autograd's host work left out); prints the backward node and the
    kernels that ran. A yardstick only: the port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    # SDPA takes its fused paths on 4-D (batch, heads, seq, dim) input
    q4, k4, v4 = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
    do4 = do[:, None]

    def backward():
        torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)

    for _ in range(2):
        backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            backward()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    ms = sum(dev_ms for dev_ms, _, _ in kernels) / 5
    names = sorted({name[:60] for _, _, name in kernels})
    print(f"    library: SDPA backward ({out4.grad_fn.name()}) {ms:.4f} ms of device time "
          f"(torch.profiler); kernels: {'; '.join(names)}", flush=True)
    return ms


def check_flash_bwd(g, fwd: KernelRecord) -> list[KernelRecord]:
    """The two backward kernels against their plain versions on the same
    residuals at every ``FLASH_BWD_CASES`` shape, and the forward's lse
    output against the plain one (counted under ``fwd``, the forward
    kernel's record). At the two path shapes each kernel runs twice and
    must give bit-identical gradients; the timed shapes print each
    kernel's time beside SDPA's whole backward (device time), its own
    device time and host time a call, and its plan."""
    import torch

    from t2v_torch.kernels import flash_attention as fa

    src = "t2v_torch/csrc/flash_attention_bwd.cu"
    dkv = KernelRecord("flash_bwd_dkv", src, "t2v/kernels/flash_attention.py:260",
                       "modelscope_lora_train")
    dq = KernelRecord("flash_bwd_dq", src, "t2v/kernels/flash_attention.py:302",
                      "modelscope_lora_train")
    for case in FLASH_BWD_CASES:
        b, n, s, d, scale = case
        q, do = (torch.randn((b, n, d), generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        label = f"q{(b, n, d)} kv{(b, s, d)}"
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        _, lse_want = fa.flash_attention_fwd_plain(q, k, v, scale)
        _compare(fwd, f"lse {label}", lse, lse_want)
        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, scale)
        got_dk, got_dv = fa.flash_attention_bwd_dkv(*args)
        got_dq = fa.flash_attention_bwd_dq(*args)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_plain(*args)
        want_dq = fa.flash_attention_bwd_dq_plain(*args)
        torch.cuda.synchronize()
        _compare(dkv, f"dk {label}", got_dk, want_dk)
        _compare(dkv, f"dv {label}", got_dv, want_dv)
        _compare(dq, f"dq {label}", got_dq, want_dq)
        del want_dk, want_dv, want_dq, lse_want
        if case in FLASH_BWD_PATH:
            again_dk, again_dv = fa.flash_attention_bwd_dkv(*args)
            again_dq = fa.flash_attention_bwd_dq(*args)
            torch.cuda.synchronize()
            same = [torch.equal(a, b_) for a, b_ in ((got_dk, again_dk), (got_dv, again_dv),
                                                     (got_dq, again_dq))]
            print(f"  flash_bwd          {label:38s} two launches bit-identical "
                  f"(dk, dv, dq): {same}", flush=True)
            if not all(same):
                _fail(f"flash backward {label}: two launches differ: {same}")
            del again_dk, again_dv, again_dq
        del got_dk, got_dv, got_dq
        dkv_plan, dq_plan = _bwd_plan_note(fa.flash_bwd_plan(b, n, s, d))
        if case in FLASH_BWD_RAGGED:  # checked, not timed
            print(f"    plan {label}: dkv {dkv_plan}; dq {dq_plan}", flush=True)
            continue
        lib_ms = _sdpa_bwd_yardstick(q, k, v, do, scale)
        prod = 2.0 * b * n * s * d
        in_bytes = 2.0 * b * d * (2 * n + 2 * s) + 8.0 * b * n
        pair = 0.0
        for rec, call, plain, kernel, products, out_bytes, plan in (
                (dkv, lambda: fa.flash_attention_bwd_dkv(*args),
                 lambda: fa.flash_attention_bwd_dkv_plain(*args), "flash_bwd_dkv_kernel", 4,
                 4.0 * b * s * d, dkv_plan),
                (dq, lambda: fa.flash_attention_bwd_dq(*args),
                 lambda: fa.flash_attention_bwd_dq_plain(*args), "flash_bwd_dq_kernel", 3,
                 2.0 * b * n * d, dq_plan)):
            dev = _kernel_device_ms(call, kernel)
            rec.timed((b, n, s, d), _time_ms(call, 10), _time_ms(plain, 3), lib_ms,
                      products * prod, in_bytes + out_bytes, main=case == FLASH_BWD_PATH[0],
                      plan=plan, device_ms=dev)
            pair += dev
            print(f"  device {rec.name:16s} {str((b, n, s, d)):26s} "
                  + (f"{dev:.4f} ms ({products * prod / dev / 1e9:.1f} TFLOP/s; torch.profiler)"
                     if dev else "not measured (the profiler recorded no device time)")
                  + f"; host {_host_us(call, 20):.1f} us a call", flush=True)
        if pair and lib_ms:
            print(f"  device flash_bwd pair  {str((b, n, s, d)):26s} {pair:.4f} ms against "
                  f"SDPA's whole backward {lib_ms:.4f} ms: {pair / lib_ms:.2f}x", flush=True)
        _release()
    return [dkv, dq]


def _mha_plan_note(p) -> str:
    return (f"{p.pairs_per_block} pair(s) x {p.tiles_per_block} query tiles, {p.warps} warps, "
            f"{p.kc}-row key chunks, {'resident' if p.resident else 'streamed'} K/V, "
            f"{p.smem_bytes} B, {p.blocks} blocks")


def check_fused_mha(g) -> list[KernelRecord]:
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.fused_mha import (
        fused_cross_mha,
        fused_cross_mha_plain,
        fused_self_mha,
        fused_self_mha_plain,
        self_mha_plan,
    )

    rec = KernelRecord("fused_self_mha", "t2v_torch/csrc/fused_mha.cu",
                       "t2v/kernels/fused_mha.py:52", "modelscope_24f")
    for b, n, h, d in SELF_MHA_CASES:
        hd = h * d
        q, k, v = (torch.randn((b, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = fused_self_mha(q, k, v, h)
        want = fused_self_mha_plain(q, k, v, h)
        torch.cuda.synchronize()
        _compare(rec, f"x{(b, n, hd)} heads={h}", got, want)
        del got, want
        if (b, n, h, d) in SELF_MHA_RAGGED:  # checked, not timed
            continue
        fold = lambda t: t.view(b, n, h, d).transpose(1, 2)
        call = lambda: fused_self_mha(q, k, v, h)  # noqa: E731
        ms = _time_ms(call, 20)
        plain_ms = _time_ms(lambda: fused_self_mha_plain(q, k, v, h), 3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(fold(q), fold(k), fold(v)), 20)
        main = (b, n, h) == (48, 256, 10)
        rec.timed((b, n, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, n, d, h),
                  main=main, plan=_mha_plan_note(self_mha_plan(b, n, n, h, d)),
                  device_ms=_kernel_device_ms(call, "packed_mha_kernel") if main else None)
        _release()

    cross = KernelRecord("fused_cross_mha", "t2v_torch/csrc/fused_mha.cu",
                         "t2v/kernels/fused_mha.py:225", "videocrafter_16f")
    for b, n, s, h, d in CROSS_MHA_CASES:
        hd = h * d
        q = torch.randn((b, n, hd), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s, hd), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        got = fused_cross_mha(q, k, v, h)
        want = fused_cross_mha_plain(q, k, v, h)
        torch.cuda.synchronize()
        _compare(cross, f"q{(b, n, hd)} kv{(b, s, hd)} heads={h}", got, want)
        del got, want
        if (b, n, s, h, d) in CROSS_MHA_RAGGED:  # checked, not timed
            continue
        fold = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)
        call = lambda: fused_cross_mha(q, k, v, h)  # noqa: E731
        ms = _time_ms(call, 20)
        plain_ms = _time_ms(lambda: fused_cross_mha_plain(q, k, v, h), 3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(fold(q), fold(k), fold(v)), 20)
        main = (n, h) == (16384, 8)
        dev = _kernel_device_ms(call, "packed_mha_kernel") if main else None
        cross.timed((b, n, s, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, s, d, h),
                    main=main, plan=_mha_plan_note(self_mha_plan(b, n, s, h, d)),
                    device_ms=dev)
        if main:
            print(f"  device fused_cross_mha {str((b, n, s, hd, h)):26s} "
                  + (f"{dev:.4f} ms (torch.profiler)" if dev
                     else "not measured (the profiler recorded no device time)")
                  + f"; host {_host_us(call, 20):.1f} us a call", flush=True)
    return [rec, cross]


def check_relpos(g) -> list[KernelRecord]:
    """Row 7 at every ``RELPOS_CASES`` shape against ``relpos_mha_plain``.
    The path shapes are timed beside the plain version with the kernel's
    device time (torch.profiler), the wrapper's host time a call, the plan
    and the time before the redesign. No library call computes this function:
    scaled_dot_product_attention takes an additive score bias but has no
    term for softmax(sim) . V2."""
    import torch

    from t2v_torch.kernels.relpos_mha import relpos_mha, relpos_mha_plain, relpos_plan

    rec = KernelRecord("relpos_mha", "t2v_torch/csrc/relpos_mha.cu",
                       "t2v/kernels/relpos_mha.py:80", "videocrafter_16f")
    for b, t, n, h, d in RELPOS_CASES:
        hd = h * d
        q, k, v = (torch.randn((b * t, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        k2, v2 = (torch.randn((t, t, d), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        got = relpos_mha(q, k, v, k2, v2, h, t)
        want = relpos_mha_plain(q, k, v, k2, v2, h, t)
        torch.cuda.synchronize()
        label = f"x{(b * t, n, hd)} heads={h} T={t}"
        _compare(rec, label, got, want)
        del got, want
        p = relpos_plan(b, t, n, h, d)
        plan = (f"{p.tokens_per_block} token(s) x {p.heads_per_block} head(s) a tile, "
                f"{p.tiles} tiles over {p.blocks} blocks of {p.warps} warps, tables "
                f"{'in shared memory' if p.tables else 'through L2'}, DP {p.dp}, "
                f"{p.smem_bytes} B")
        if (b, t, n, h, d) in RELPOS_RAGGED:  # checked, not timed
            print(f"    plan {label}: {plan}", flush=True)
            continue
        shape = (b * t, n, hd, h)
        call = lambda: relpos_mha(q, k, v, k2, v2, h, t)  # noqa: E731
        ms = _time_ms(call, 20)
        plain_ms = _time_ms(lambda: relpos_mha_plain(q, k, v, k2, v2, h, t), 3)
        items = b * n * h
        main = (n, h) == (1024, 8)
        dev = _kernel_device_ms(call, "relpos_mha_kernel")
        rec.timed(shape, ms, plain_ms, None, 8.0 * items * t * t * d,
                  2.0 * (4 * b * t * n * hd + 2 * t * t * d), main=main, plan=plan,
                  before_key=None if main else f"relpos_mha {shape}", device_ms=dev)
        before = (f" (before the redesign {RELPOS_HOST_US_BEFORE[0]:.1f}-"
                  f"{RELPOS_HOST_US_BEFORE[1]:.1f} us)" if main else "")
        print(f"  device relpos_mha      {str(shape):26s} "
              + (f"{dev:.4f} ms (torch.profiler)" if dev
                 else "not measured (the profiler recorded no device time)")
              + f"; host {_host_us(call, 20):.1f} us a call{before}", flush=True)
        del q, k, v
        _release()
    return [rec]


def check_temporal_mha(g) -> list[KernelRecord]:
    """Row 9: frame-axis attention through its dispatch entry
    ``temporal_attention_packed`` (which, on these CUDA tensors with F < 512,
    launches ``fused_temporal_mha``) against the plain version."""
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.attention import temporal_attention_packed
    from t2v_torch.kernels.fused_mha import fused_temporal_mha_plain, self_mha_plan

    rec = KernelRecord("fused_temporal_mha", "t2v_torch/csrc/fused_mha.cu",
                       "t2v/kernels/fused_mha.py:104", "modelscope_unet_capture")
    for b, f, n, h, d in TEMPORAL_MHA_CASES:
        hd = h * d
        q, k, v = (torch.randn((b * f, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = temporal_attention_packed(q, k, v, h, f)
        want = fused_temporal_mha_plain(q, k, v, h, f)
        torch.cuda.synchronize()
        _compare(rec, f"x{(b * f, n, hd)} heads={h} F={f}", got, want)
        del got, want
        if (b, f, n, h, d) in TEMPORAL_MHA_RAGGED or n == 16:  # checked, not timed
            continue
        # the library yardstick: one SDPA on the 4-D (B, N*H, F, D) view of
        # the same memory (last dim contiguous, so the flash backend takes
        # it), held against the plain version so it computes the same function
        view = lambda t: t.view(b, f, n * h, d).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(view(q), view(k), view(v))
        lib_rec = KernelRecord("sdpa yardstick", "", "", "")
        _compare(lib_rec, f"x{(b * f, n, hd)} F={f}", lib().transpose(1, 2).reshape(q.shape),
                 fused_temporal_mha_plain(q, k, v, h, f))
        call = lambda: temporal_attention_packed(q, k, v, h, f)  # noqa: E731
        ms = _time_ms(call, 10)
        plain_ms = _time_ms(lambda: fused_temporal_mha_plain(q, k, v, h, f), 3)
        lib_ms = _time_ms(lib, 10)
        main = (f, n) == (T, 1024)
        rec.timed((b * f, n, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b * n, f, f, d, h),
                  main=main, plan=_mha_plan_note(self_mha_plan(b * n, f, f, h, d)),
                  device_ms=_kernel_device_ms(call, "packed_mha_kernel") if main else None)
        del q, k, v
        _release()
    return [rec]


# flops per GEGLU output value counted for the bound (scale, erf, add, two
# products); the bound is the bytes by two orders of magnitude either way
GEGLU_FLOPS = 6


def check_geglu(g) -> list[KernelRecord]:
    """Row 10: the GEGLU combine through its entry ``geglu`` against the
    plain version, at the projections of every ModelScope GEGLU site."""
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.geglu import geglu, geglu_plain

    rec = KernelRecord("geglu", "t2v_torch/csrc/geglu.cu", "t2v/kernels/geglu.py:63",
                       "modelscope_unet_capture")
    # (rows, 2 * inner): the four levels at 24 frames with CFG (2 x 24 x HW
    # tokens, inner = 4 x channels), the 1024x576 top level, an odd row count
    # and a small inner
    ragged = [(4099, 2560), (37, 16)]
    cases = [(49152, 2560), (12288, 5120), (3072, 10240), (768, 10240), (442368, 2560), *ragged]
    for rows, two_inner in cases:
        proj = torch.randn((rows, two_inner), generator=g, device="cuda").to(torch.bfloat16)
        got = geglu(proj)
        want = geglu_plain(proj)
        torch.cuda.synchronize()
        # both compute h * gelu(gate) in f32 and round once to bf16: they
        # may differ by one flipped rounding where erff and torch's erf do
        _compare_steps(rec, f"proj{(rows, two_inner)}", got, want, 1)
        del got, want
        if (rows, two_inner) in ragged:  # checked, not timed
            continue
        inner = two_inner // 2
        h, gate = proj[:, :inner], proj[:, inner:]
        call = lambda: geglu(proj)  # noqa: E731
        ms = _time_ms(call, 20)
        plain_ms = _time_ms(lambda: geglu_plain(proj), 3)
        # the library yardstick is two calls, F.gelu and the product, in bf16
        lib_ms = _time_ms(lambda: h * F.gelu(gate), 20)
        main = (rows, two_inner) == (49152, 2560)
        rec.timed((rows, two_inner), ms, plain_ms, lib_ms, GEGLU_FLOPS * rows * inner,
                  2.0 * rows * (two_inner + inner), main=main,
                  device_ms=_kernel_device_ms(call, "geglu_kernel") if main else None)
        del proj, h, gate
        _release()
    return [rec]


# the sources of the redesigned kernels, whose every entry
# function's registers, spills and stack the build prints
REDESIGNED = ("temporal_conv", "fused_mha", "flash_attention", "flash_attention_bwd",
              "relpos_mha")


def _kernel_label(mangled: str) -> str:
    """``temporal_conv_gemm_kernel<128,320>`` from an Itanium-mangled name."""
    import re

    base = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    args += [r for r in ("TokenRows", "FrameRows") if r in mangled]
    return (base.group(1) if base else mangled[:60]) + (f"<{','.join(args)}>" if args else "")


def _ptxas_report(log: str) -> list[str]:
    """One line per entry function of an ``nvcc -Xptxas -v`` log."""
    import re

    lines, name, spill = [], None, ""
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if entry:
            name = _kernel_label(entry.group(1))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                         f"{smem.group(1) if smem else 0} B static shared memory "
                         f"(dynamic: the plan's), {spill}")
            name, spill = None, ""
    return lines


def build_kernels() -> float:
    from t2v_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(list(_build.KERNELS))
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        spills = [ln for ln in regs if "spill" in ln and "0 bytes spill stores, 0 bytes spill" not in ln]
        print(f"  {name}: {len(regs) // 2} kernels, "
              + (" | ".join(regs[:2]) if regs else "(built before)")
              + (f" | SPILLS: {' | '.join(spills[:3])}" if spills else ""), flush=True)
        if name in REDESIGNED:
            for line in _ptxas_report(log):
                print(f"    ptxas {line}", flush=True)
    print(f"build: {secs:.1f} s for {len(logs)} sources", flush=True)
    return secs


def check_refusals() -> None:
    """Each wrapper raises ValueError on a CUDA tensor its kernel does not
    take (wrong dtype, shape or contiguity), and launches nothing."""
    import torch

    from t2v_torch.kernels import flash_attention, fused_mha, geglu, relpos_mha, temporal_conv

    def bf16(*shape):
        return torch.zeros(shape, device="cuda", dtype=torch.bfloat16)

    c = 64
    vec = torch.zeros(c, device="cuda")
    fin = torch.zeros(2, 2, c, device="cuda")
    w = bf16(3, c, c)
    q = bf16(2, 24, 2 * 64)
    rq = bf16(8, 6, 80)  # rel-pos: 2 samples x 4 frames, 6 tokens, 2 heads of 40
    r2 = bf16(4, 4, 40)
    rows = torch.zeros(2, 8, device="cuda")   # an lse of the right shape
    bad_calls = {
        "temporal_conv float32 x": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 3, 8, c).float(), fin, vec, vec, w, vec),
        "temporal_conv strided x": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 8, 3, c).transpose(1, 2), fin, vec, vec, w, vec),
        "temporal_conv weight shape": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 3, 8, c), fin, vec, vec, bf16(3, c, 32), vec),
        "flash float32": lambda: flash_attention.flash_attention(
            *(bf16(2, 8, 64).float() for _ in range(3))),
        "flash head dim 48": lambda: flash_attention.flash_attention(
            *(bf16(2, 8, 48) for _ in range(3))),
        "flash strided q": lambda: flash_attention.flash_attention(
            bf16(2, 64, 8).transpose(1, 2), bf16(2, 8, 64), bf16(2, 8, 64)),
        "flash backward head dim 512": lambda: flash_attention.flash_attention_bwd(
            *(bf16(2, 8, 512) for _ in range(4)), rows, bf16(2, 8, 512)),
        "flash backward float32 gradient": lambda: flash_attention.flash_attention_bwd(
            *(bf16(2, 8, 64) for _ in range(4)), rows, bf16(2, 8, 64).float()),
        "flash backward lse shape": lambda: flash_attention.flash_attention_bwd(
            *(bf16(2, 8, 64) for _ in range(4)), torch.zeros(2, 9, device="cuda"),
            bf16(2, 8, 64)),
        "fused_self_mha float32": lambda: fused_mha.fused_self_mha(q.float(), q.float(), q.float(), 2),
        "fused_self_mha N 512": lambda: fused_mha.fused_self_mha(*(bf16(2, 512, 128),) * 3, 2),
        "fused_self_mha head dim 32": lambda: fused_mha.fused_self_mha(*(bf16(2, 24, 64),) * 3, 2),
        "fused_self_mha strided": lambda: fused_mha.fused_self_mha(
            *(bf16(2, 128, 24).transpose(1, 2),) * 3, 2),
        "fused_cross_mha float32 q": lambda: fused_mha.fused_cross_mha(
            q.float(), bf16(2, 77, 128), bf16(2, 77, 128), 2),
        "fused_cross_mha context batch": lambda: fused_mha.fused_cross_mha(
            q, bf16(3, 77, 128), bf16(3, 77, 128), 2),
        "fused_cross_mha S 512": lambda: fused_mha.fused_cross_mha(
            q, bf16(2, 512, 128), bf16(2, 512, 128), 2),
        "fused_cross_mha k/v widths": lambda: fused_mha.fused_cross_mha(
            q, bf16(2, 77, 64), bf16(2, 77, 64), 2),
        "relpos_mha float32": lambda: relpos_mha.relpos_mha(
            rq.float(), rq.float(), rq.float(), r2.float(), r2.float(), 2, 4),
        "relpos_mha frame_split": lambda: relpos_mha.relpos_mha(rq, rq, rq, r2, r2, 2, 3),
        "relpos_mha table shape": lambda: relpos_mha.relpos_mha(
            rq, rq, rq, bf16(4, 4, 80), bf16(4, 4, 80), 2, 4),
        "relpos_mha head dim 20": lambda: relpos_mha.relpos_mha(
            rq, rq, rq, bf16(4, 4, 20), bf16(4, 4, 20), 4, 4),
        "relpos_mha strided": lambda: relpos_mha.relpos_mha(
            *(bf16(8, 80, 6).transpose(1, 2),) * 3, r2, r2, 2, 4),
        "fused_temporal_mha float32": lambda: fused_mha.fused_temporal_mha(
            *(bf16(8, 6, 128).float(),) * 3, 2, 4),
        "fused_temporal_mha head dim 32": lambda: fused_mha.fused_temporal_mha(
            *(bf16(8, 6, 64),) * 3, 2, 4),
        "fused_temporal_mha strided": lambda: fused_mha.fused_temporal_mha(
            *(bf16(8, 128, 6).transpose(1, 2),) * 3, 2, 4),
        "fused_temporal_mha rows not whole samples": lambda: fused_mha.fused_temporal_mha(
            *(bf16(9, 6, 128),) * 3, 2, 4),
        "fused_temporal_mha F 512": lambda: fused_mha.fused_temporal_mha(
            *(bf16(512, 2, 128),) * 3, 2, 512),
        "geglu float32": lambda: geglu.geglu(bf16(4, 32).float()),
        "geglu strided": lambda: geglu.geglu(bf16(32, 4).transpose(0, 1)),
        "geglu inner 12": lambda: geglu.geglu(bf16(4, 24)),
        "geglu odd width": lambda: geglu.geglu(bf16(4, 33)),
    }
    counters = _counters().values()
    before = [k.count for k in counters]
    for label, call in bad_calls.items():
        try:
            call()
        except ValueError:
            continue
        _fail(f"{label}: the wrapper accepted a CUDA tensor its kernel does not take")
    if [k.count for k in counters] != before:
        _fail("a refused call counted a launch")
    print(f"refusals: {len(bad_calls)} malformed CUDA inputs raised ValueError", flush=True)


def check_kernels() -> list[KernelRecord]:
    import torch

    check_refusals()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    with torch.no_grad():
        conv = check_temporal_conv(g)
        flash = check_flash(g)
        return [*conv, *flash, *check_flash_bwd(g, flash[0]), *check_fused_mha(g),
                *check_relpos(g), *check_temporal_mha(g), *check_geglu(g)]


def _models(pipe):
    text = pipe.text_encoder.model if hasattr(pipe, "text_encoder") else pipe.clip
    return pipe.unet, pipe.vae, text


def _perturb_zero_leaves(pipe) -> None:
    """Add 0.01 to every all-zero parameter: the zero-initialised gates of a
    random-weight pipeline would make every UNet output 0, and VideoCrafter's
    zero temporal q/k/v/out would leave its rel-pos kernel without signal."""
    import torch

    with torch.no_grad():
        for mod in _models(pipe):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)


def _counters():
    from t2v_torch.kernels import flash_attention, fused_mha, geglu, relpos_mha, temporal_conv

    return {"temporal_conv": temporal_conv.COUNTER, "flash_attention": flash_attention.COUNTER,
            "flash_bwd_dkv": flash_attention.DKV_COUNTER,
            "flash_bwd_dq": flash_attention.DQ_COUNTER,
            "fused_self_mha": fused_mha.COUNTER, "fused_cross_mha": fused_mha.CROSS_COUNTER,
            "relpos_mha": relpos_mha.COUNTER,
            "fused_temporal_mha": fused_mha.TEMPORAL_COUNTER, "geglu": geglu.COUNTER}


def _reset_counters() -> None:
    for c in _counters().values():
        c.reset()


def _read_counters() -> dict:
    return {k: c.count for k, c in _counters().items()}


@contextlib.contextmanager
def _no_plain_on_cuda():
    """While active, a kernel wrapper's plain version raises when it is
    handed a CUDA tensor: the driven paths must go through the kernels.
    (The dispatch's own plain routes, ``attention.attention_plain`` for the
    short contexts and the plain versions for what no kernel takes, are not
    a wrapper's fallback and are left alone; the launch counts hold the
    bf16 paths to the kernels. Nor are the recompute
    backwards ``fused_mha_backward``, ``relpos_mha_backward`` and
    ``chain_backward``, which run plain math on the card by design, as the
    JAX package's custom VJPs do.)"""
    from t2v_torch.kernels import flash_attention, fused_mha, geglu, relpos_mha, temporal_conv

    targets = [(flash_attention, "flash_attention_plain"),
               (flash_attention, "flash_attention_fwd_plain"),
               (flash_attention, "flash_attention_bwd_plain"),
               (flash_attention, "flash_attention_bwd_dkv_plain"),
               (flash_attention, "flash_attention_bwd_dq_plain"),
               (fused_mha, "fused_self_mha_plain"),
               (fused_mha, "fused_cross_mha_plain"), (fused_mha, "fused_temporal_mha_plain"),
               (relpos_mha, "relpos_mha_plain"), (temporal_conv, "layer_plain"),
               (geglu, "geglu_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def guard(name, fn):
        def guarded(x, *args, **kwargs):
            if x.is_cuda:
                _fail(f"{name} ran on a CUDA tensor: a wrapper fell back to its plain version")
            return fn(x, *args, **kwargs)
        return guarded

    for mod, name, fn in saved:
        setattr(mod, name, guard(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# small pipelines whose widths every kernel takes. ModelScope: channels a
# multiple of 64, 64-wide heads; VideoCrafter: 160 and 320 channels over 4
# heads, i.e. the 40- and 80-wide heads of the full model's upper levels.
# At 64x64 px (a 32x32 latent under the two-level VAE) the 1,024-token
# attention goes to flash and the rest to the packed kernels
SMALL_UNET = dict(dim=64, context_dim=64, dim_mult=(1, 2), num_res_blocks=1, num_heads=1,
                  head_dim=64, attn_scales=(1.0, 0.5))
SMALL_VC_UNET = dict(model_channels=160, context_dim=64, channel_mult=(1, 2), num_res_blocks=1,
                     num_heads=4, attention_resolutions=(1, 2), temporal_length=8)
# the card's bf16 run may be at most this many times as far from the float32
# reference as the plain bf16 run on the CPU: both round at the same points
# and differ in summation order, so their distances are of one size
SMALL_RATIO = 2.0


def _small_pipeline_check(label, build, args, noise, device) -> dict:
    """One seeded small pipeline answers one request from the same starting
    noise three times: float32 on the CPU (the reference), bf16 on the CPU
    (the plain versions: the distance bf16 alone makes), and bf16 on
    ``device`` (the kernels). Fails when the last is more than SMALL_RATIO
    times as far from the reference as the second, in relative RMS of the
    final latents and of the uint8 frames. ``build(policy, device)`` makes
    the pipeline. Returns the kernels' launches in the ``device`` run."""
    import torch

    from t2v_torch.core.dtypes import Policy

    ref = build(Policy.fp32(), "cpu")
    _perturb_zero_leaves(ref)
    t0 = time.perf_counter()
    want = ref.infer(args, noise=noise)
    cpu16 = _copied(build, ref, Policy.bf16(), "cpu").infer(args, noise=noise)
    t_cpu = time.perf_counter() - t0
    pipe = _copied(build, ref, Policy.bf16(), device)
    _reset_counters()
    t0 = time.perf_counter()
    got = pipe.infer(args, noise=noise)
    t_dev = time.perf_counter() - t0
    launches = _read_counters()
    for what, pick in (("latents", lambda r: r.latents), ("frames", lambda r: r.frames)):
        _within_ratio(f"{label} {what}", pick(got), pick(cpu16), pick(want), device)
    print(f"{label} launches on {device}: {launches}; {t_dev:.2f} s on {device}, "
          f"{t_cpu:.2f} s for the two CPU runs", flush=True)
    return launches


def _copied(build, ref, policy, device):
    """``build(policy, device)`` with ``ref``'s weights."""
    pipe = build(policy, device)
    for dst, src in zip(_models(pipe), _models(ref)):
        dst.load_state_dict(src.state_dict())
    return pipe


def _within_ratio(label, got, cpu16, want, device="cuda") -> None:
    """Fail unless ``got`` (bf16 on the card) is at most SMALL_RATIO times
    as far from the float32 reference ``want`` as ``cpu16`` (the same bf16
    computation on the CPU) is, in relative RMS."""
    import torch

    def rel(a, b) -> float:
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        return ((a - b).norm() / b.norm()).item()

    err, floor = rel(got, want), rel(cpu16, want)
    ok = err <= SMALL_RATIO * floor
    print(f"{label}: bf16 on {device} {err:.3e} from the float32 reference, "
          f"bf16 on cpu {floor:.3e}, limit {SMALL_RATIO * floor:.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        _fail(f"{label}: {err} from the reference, above {SMALL_RATIO} x {floor}")


def check_small_pipeline(device: str = "cuda") -> dict:
    """The ModelScope path on a small input against a float32 reference:
    8 frames at 64x64, 4 DDIM_Gaussian steps, CFG 9."""
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    cfg = ModelScopeUNetConfig(**SMALL_UNET)
    args = T2VArgs(prompt="a (red:1.2) fox running in the snow", seed=3, steps=4, frames=8,
                   width=64, height=64, cfg_scale=CFG)
    noise = torch.randn((1, 8, 32, 32, 4), generator=torch.Generator().manual_seed(3))
    return _small_pipeline_check(
        "small pipeline",
        lambda policy, dev: ModelScopePipeline.random_init(cfg, policy, seed=0, device=dev),
        args, noise, device)


def check_small_vc_pipeline(device: str = "cuda") -> dict:
    """The VideoCrafter path on a small input against a float32 reference:
    8 frames at 64x64, 4 DDIM steps, CFG 9; the zero-initialised temporal
    q/k/v/out are perturbed with the other zero leaves, so the rel-pos
    kernel carries signal."""
    import torch

    from t2v_torch.core.config import T2VArgs, VideoCrafterUNetConfig
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    cfg = VideoCrafterUNetConfig(**SMALL_VC_UNET)
    args = T2VArgs(prompt="a red fox running in the snow", n_prompt="blurry", seed=3, steps=4,
                   frames=8, width=64, height=64, cfg_scale=CFG)
    noise = torch.randn((1, 8, 32, 32, 4), generator=torch.Generator().manual_seed(4))
    return _small_pipeline_check(
        "small VideoCrafter pipeline",
        lambda policy, dev: VideoCrafterPipeline.random_init(cfg, policy, seed=0, device=dev,
                                                             small_aux=True),
        args, noise, device)


# the float32 pipeline on the card against the same pipeline in float32 on
# the CPU: the latents within this relative RMS (both run every product in
# full float32, with TF32 off; they differ in summation order, about 1e-6
# of a value a product, grown through 4 CFG-9 steps of the UNet, an order
# of magnitude below the 1e-2 that one bf16 rounding in the path makes),
# and the uint8 frames at most this many levels apart (a float difference
# far below one level can still cross one rounding boundary)
FP32_LATENT_REL = 1e-3
FP32_FRAME_LEVELS = 1


@contextlib.contextmanager
def _full_fp32():
    """Float32 convolutions and matmuls in full float32 (no TF32), restored
    after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def check_fp32_pipelines() -> None:
    """The small ModelScope and VideoCrafter pipelines built with
    ``Policy.fp32()`` on the card: the dispatch routes every attention and
    temporal-conv call to the plain versions there (no kernel takes
    float32), so the request launches no kernel, by the counters, and its
    latents and frames match the same pipeline's float32 CPU run."""
    import numpy as np
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs, VideoCrafterUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.pipeline.pipeline import ModelScopePipeline
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    ms_cfg, vc_cfg = ModelScopeUNetConfig(**SMALL_UNET), VideoCrafterUNetConfig(**SMALL_VC_UNET)
    cases = [
        ("ModelScope", lambda dev: ModelScopePipeline.random_init(
            ms_cfg, Policy.fp32(), seed=0, device=dev),
         T2VArgs(prompt="a (red:1.2) fox running in the snow", seed=3, steps=4, frames=8,
                 width=64, height=64, cfg_scale=CFG), 3),
        ("VideoCrafter", lambda dev: VideoCrafterPipeline.random_init(
            vc_cfg, Policy.fp32(), seed=0, device=dev, small_aux=True),
         T2VArgs(prompt="a red fox running in the snow", n_prompt="blurry", seed=3, steps=4,
                 frames=8, width=64, height=64, cfg_scale=CFG), 4),
    ]
    for label, build, args, seed in cases:
        noise = torch.randn((1, 8, 32, 32, 4), generator=torch.Generator().manual_seed(seed))
        ref = build("cpu")
        _perturb_zero_leaves(ref)
        want = ref.infer(args, noise=noise)
        pipe = build("cuda")
        for dst, src in zip(_models(pipe), _models(ref)):
            dst.load_state_dict(src.state_dict())
        with _full_fp32():
            _reset_counters()
            got = pipe.infer(args, noise=noise)
            torch.cuda.synchronize()
            launches = _read_counters()
        lat_got, lat_want = got.latents.double().cpu(), want.latents.double()
        rel = ((lat_got - lat_want).norm() / lat_want.norm()).item()
        levels = int(np.abs(got.frames.astype(np.int16) - want.frames.astype(np.int16)).max())
        ok = not any(launches.values()) and rel <= FP32_LATENT_REL and levels <= FP32_FRAME_LEVELS
        print(f"float32 {label} pipeline on {torch.cuda.get_device_name(0)}: latents "
              f"{rel:.3e} from the float32 CPU run (limit "
              f"{FP32_LATENT_REL:.0e}), frames at most {levels} level(s) apart (limit "
              f"{FP32_FRAME_LEVELS}), launches {launches} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            _fail(f"float32 {label} pipeline on the card: launches {launches}, latents {rel} "
                  f"from the CPU run, frames {levels} levels apart")
        del ref, pipe
        _release()


def _answer(label, pipe, args, frames, expected, unet_steps, **infer_kwargs):
    """One full-width request, ``pipe.infer(args, **infer_kwargs)``, with
    the plain versions barred from CUDA tensors; prints seconds per phase (and per UNet step over
    ``unet_steps``), peak memory, the frames' shape, dtype and finiteness,
    and fails on non-finite latents, flat frames or launch counts other
    than ``expected``. Returns (launch counts, result)."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    with _no_plain_on_cuda():
        res = pipe.infer(args, **infer_kwargs)
    total = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fr = res.frames
    finite = bool(np.isfinite(res.latents.cpu().numpy()).all())
    tm = res.timings
    print(f"{label}: {total:.3f} s/video (text {tm['text']:.3f}, sample "
          f"{tm['sample']:.3f}, decode {tm['decode']:.3f}; {1e3 * tm['sample'] / unet_steps:.2f} "
          f"ms per step over {unet_steps} steps), peak {peak:.2f} GiB, frames "
          f"{fr.shape} {fr.dtype}, latents finite={finite}, frame mean {fr.mean():.2f} "
          f"std {fr.std():.2f}, launches {counts}", flush=True)
    if fr.shape != (frames, PX, PX, 3) or fr.dtype != np.uint8:
        _fail(f"{label}: frames {fr.shape} {fr.dtype}, expected ({frames}, {PX}, {PX}, 3) uint8")
    if not finite:
        _fail(f"{label}: latents are not finite")
    if fr.std() == 0:
        _fail(f"{label}: every pixel is the same")
    if counts != expected:
        _fail(f"{label}: launch counts {counts} differ from the topology's {expected}")
    return counts, res


def _expected(per_call: dict, steps: int, decodes: int) -> dict:
    out = {k: 0 for k in _counters()}
    out.update({k: steps * v for k, v in per_call.items()})
    out["flash_attention"] += decodes  # the VAE's mid-block attention, once per decode call
    return out


def drive_modelscope(serve: bool = True, train: bool = True) -> dict:
    """One full-width ModelScope pipeline. ``serve``: two 24-frame requests,
    one UNet-call profile, one 125-frame request. ``train``: a LoRA run
    (rank 4, 3 steps) and a full fine-tune with EMA 0.9999 (2 steps).
    Returns the kernels' launches per path."""
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    t0 = time.perf_counter()
    pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0,
                                          device="cuda")
    _perturb_zero_leaves(pipe)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"ModelScope pipeline: random_init {time.perf_counter() - t0:.1f} s, UNet "
          f"{n_unet / 1e9:.3f}B params, bf16 on {torch.cuda.get_device_name(0)}", flush=True)

    launches = {}
    if serve:
        launches.update(_serve_modelscope(pipe))
    if train:
        per_call = count_kernel_sites(pipe.unet_cfg, TRAIN_T, LAT, LAT)
        launches["modelscope_lora_train"] = _train_run(
            "ModelScope LoRA rank 4", pipe, per_call, lora_rank=4, ema_decay=None, steps=3,
            seed=21)
        launches["modelscope_full_train"] = _train_run(
            "ModelScope full fine-tune, EMA 0.9999", pipe, per_call, lora_rank=0,
            ema_decay=0.9999, steps=2, seed=22)
    del pipe
    _release()
    return launches


def _serve_modelscope(pipe) -> dict:
    import torch

    from t2v_torch.core.config import T2VArgs
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline.pipeline import decode_chunk_frames

    launches = {}
    expected = _expected(count_kernel_sites(pipe.unet_cfg, T, LAT, LAT), STEPS, 1)
    requests = [
        T2VArgs(prompt="a photo of a cat in the forest", seed=1234, steps=STEPS, frames=T,
                width=256, height=256, cfg_scale=CFG),
        T2VArgs(prompt="a (bunny:1.3) in a [forest], masterpiece", seed=77, steps=STEPS,
                frames=T, width=256, height=256, cfg_scale=CFG),
    ]
    for i, args in enumerate(requests):
        launches["modelscope_24f"] = _answer(f"ModelScope 24f request {i}", pipe, args, T,
                                             expected, STEPS)[0]

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    ctx = torch.randn((2, 77, pipe.unet_cfg.context_dim), generator=g, device="cuda")
    profile_unet("ModelScope", pipe.unet, T, ctx, g)

    decodes = -(-T_LONG // decode_chunk_frames(T_LONG, 256, 256))
    expected = _expected(count_kernel_sites(pipe.unet_cfg, T_LONG, LAT, LAT), STEPS_LONG, decodes)
    args = T2VArgs(prompt="a photo of a cat in the forest", seed=99, steps=STEPS_LONG,
                   frames=T_LONG, width=256, height=256, cfg_scale=CFG)
    launches["modelscope_125f"] = _answer("ModelScope 125f request", pipe, args, T_LONG,
                                          expected, STEPS_LONG)[0]
    return launches


# the repo's small BPE merge list, shipped under the published vocab name
VOCAB = REPO / "tests" / "data" / "tokenizer_merges.txt.gz"
GEN_PROMPT = "a (bunny:1.3) in a [forest], masterpiece"
GEN_SEED = 1234


def _write_model_dir(pipe, out: Path) -> int:
    """A ModelScope directory in the published layout from ``pipe``:
    ``configuration.json``, ``text2video_pytorch_model.pth`` and
    ``open_clip_pytorch_model.bin`` (float32 state dicts; the text tower's
    file with a visual key and ``logit_scale`` beside it, which the loader
    ignores), ``VQGAN_autoencoder.pth`` (float32, under ``state_dict`` with
    ``first_stage_model.`` prefixes and a ``loss.`` key) and the vocab.
    Returns the bytes written."""
    import shutil

    import torch

    cfg = pipe.unet_cfg
    out.mkdir(parents=True)
    model_cfg = {"unet_in_dim": cfg.in_dim, "unet_dim": cfg.dim, "unet_y_dim": cfg.y_dim,
                 "unet_context_dim": cfg.context_dim, "unet_out_dim": cfg.out_dim,
                 "unet_dim_mult": list(cfg.dim_mult), "unet_num_heads": cfg.num_heads,
                 "unet_head_dim": cfg.head_dim, "unet_res_blocks": cfg.num_res_blocks,
                 "unet_attn_scales": list(cfg.attn_scales), "unet_dropout": cfg.dropout,
                 "temporal_attention": str(cfg.temporal_attention),
                 "num_timesteps": cfg.num_timesteps,
                 "mean_type": cfg.parameterization}
    (out / "configuration.json").write_text(json.dumps({"framework": "pytorch", "model": {
        "type": "latent-text-to-video-synthesis", "model_cfg": model_cfg,
        "model_args": {"ckpt_clip": "open_clip_pytorch_model.bin",
                       "ckpt_unet": "text2video_pytorch_model.pth",
                       "ckpt_autoencoder": "VQGAN_autoencoder.pth"}}}))
    f32 = lambda m, prefix="": {prefix + k: v.float().cpu() for k, v in m.state_dict().items()}
    torch.save(f32(pipe.unet), out / "text2video_pytorch_model.pth")
    vae = f32(pipe.vae, "first_stage_model.")
    vae["loss.logvar"] = torch.zeros(())
    torch.save({"state_dict": vae}, out / "VQGAN_autoencoder.pth")
    clip = f32(pipe.text_encoder.model)
    clip.update({"visual.proj": torch.zeros(1280, 1024), "logit_scale": torch.tensor(4.6052)})
    torch.save(clip, out / "open_clip_pytorch_model.bin")
    shutil.copy(VOCAB, out / "bpe_simple_vocab_16e6.txt.gz")
    return sum(f.stat().st_size for f in out.iterdir())


class _Recorded(list):
    """``infer`` results in call order; ``pipes`` holds the pipeline that
    answered each."""

    def __init__(self):
        super().__init__()
        self.pipes = []


@contextlib.contextmanager
def _recording_infer(cls=None):
    """While active, every ``cls.infer`` result (``ModelScopePipeline`` by
    default) is appended to the yielded list, and its pipeline to the
    list's ``pipes`` (the CLI and the API return neither)."""
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    cls = cls or ModelScopePipeline
    results, infer = _Recorded(), cls.infer

    def recording(self, *args, **kwargs):
        res = infer(self, *args, **kwargs)
        results.append(res)
        results.pipes.append(self)
        return res

    cls.infer = recording
    try:
        yield results
    finally:
        cls.infer = infer


@contextlib.contextmanager
def _no_frame_files(active: bool):
    """Without ``cv2`` on the host, ``run`` writes no PNG and no mp4: every
    call of it gets ``save_frames=False`` and ``skip_video_creation``."""
    from t2v_torch.pipeline import run as run_mod

    run = run_mod.run

    def without_files(args, out_args=None, **kwargs):
        out_args = (out_args or run_mod.T2VOutputArgs()).replace(skip_video_creation=True)
        return run(args, out_args, **{**kwargs, "save_frames": False})

    if active:
        run_mod.run = without_files
    try:
        yield
    finally:
        run_mod.run = run


def _module_bytes(*modules) -> int:
    return sum(p.numel() * p.element_size() for m in modules for p in m.parameters())


def _same_weights(pipe, src) -> int:
    """Fail unless every tensor of ``pipe``'s three models equals
    ``src``'s bit for bit, on the same device in the same dtype; returns
    how many there are. (A function of its own, so that no module stays
    referenced by a loop variable after it.)"""
    import torch

    mismatched, n = [], 0
    for a, b in zip(_models(pipe), _models(src)):
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys():
            _fail(f"generate: loaded keys differ: {sorted(set(sa) ^ set(sb))[:5]}")
        n += len(sa)
        mismatched += [k for k in sa if sa[k].dtype != sb[k].dtype
                       or sa[k].device != sb[k].device or not torch.equal(sa[k], sb[k])]
    if mismatched:
        _fail(f"generate: {len(mismatched)} loaded tensors differ from the source, e.g. "
              f"{mismatched[:3]}")
    return n


def _same_frames(label, got, want) -> None:
    import numpy as np

    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (np.abs(got.astype(int) - want.astype(int)).max() if got.shape == want.shape
                else f"shapes {got.shape} / {want.shape}")
        _fail(f"{label}: frames differ from the source pipeline's (max level difference {diff})")


def drive_generate() -> dict:
    """ModelScope from a model directory to an mp4: write a full-width
    directory in the published layout from a seeded bf16 pipeline, load it
    with ``load_pipeline`` (every parameter bit-identical), answer the same
    24-frame request with the source and the loaded pipeline (identical
    frames), then through ``cli.generate.main`` and through the stdlib API
    server on 127.0.0.1 (launch counts, identical frames), then a 'Main
    Model Only' pair (``release_aux`` frees the VAE's and the text tower's
    memory; the reloaded request's frames are identical). Returns the
    launches of the CLI and API requests."""
    import os
    import shutil
    import tempfile
    import urllib.parse
    import urllib.request

    import torch

    from t2v_torch.api.stdlib_server import serve
    from t2v_torch.cli import generate
    from t2v_torch.core.config import CLIPTextConfig, ModelScopeUNetConfig, T2VArgs, T2VOutputArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline import pipeline as pl
    from t2v_torch.pipeline import run as run_mod
    from t2v_torch.text.tokenizer import CLIPTokenizer

    try:
        import cv2  # noqa: F401
        files = True
    except ImportError:
        files = False
        print("generate: cv2 cannot be imported here: the CLI, API and run requests pass "
              "--skip-video-creation and save_frames=False (the CPU tests cover the PNG and "
              "mp4 writes)", flush=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_models_", dir=REPO))
    launches, srv, saved_root = {}, None, os.environ.get("T2V_MODELS_ROOT")
    try:
        src = pl.ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=3,
                                                device="cuda",
                                                clip_cfg=CLIPTextConfig.vit_h_14())
        _perturb_zero_leaves(src)
        src.text_encoder.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
        emb = tuple(src.text_encoder.model.token_embedding.weight.shape)
        if emb != (49408, 1024):
            _fail(f"generate: the text tower's embedding is {emb}, not the published "
                  "(49408, 1024)")
        model_dir = root / "text2video" / "chip_smoke"
        t0 = time.perf_counter()
        nbytes = _write_model_dir(src, model_dir)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()  # the load below then reads clean pages, not the write's dirty ones
        t_sync = time.perf_counter() - t0

        _release()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = pl.load_pipeline(str(model_dir))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        n = _same_weights(pipe, src)
        print(f"generate: wrote {nbytes / 1e9:.3f} GB of float32 files in {t_write:.2f} s "
              f"(then os.sync {t_sync:.2f} s); "
              f"load_pipeline {t_load:.2f} s ({nbytes / 1e9 / t_load:.2f} GB/s), "
              f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.2f} GiB on the card; {n} "
              f"tensors bit-identical to the source", flush=True)
        t0 = time.perf_counter()
        again = pl.ModelScopePipeline.from_model_dir(str(model_dir))
        torch.cuda.synchronize()
        t_again = time.perf_counter() - t0
        _same_weights(again, src)
        del again
        _release()
        print(f"generate: a second from_model_dir of the same files {t_again:.2f} s "
              f"({nbytes / 1e9 / t_again:.2f} GB/s)", flush=True)

        expected = _expected(count_kernel_sites(pipe.unet_cfg, T, LAT, LAT), STEPS, 1)
        args = T2VArgs(prompt=GEN_PROMPT, seed=GEN_SEED, steps=STEPS, frames=T, width=PX,
                       height=PX, cfg_scale=CFG)
        want = _answer("generate: source pipeline 24f", src, args, T, expected, STEPS)[1].frames
        got = _answer("generate: loaded pipeline 24f", pipe, args, T, expected, STEPS)[1]
        _same_frames("generate: the loaded pipeline", got.frames, want)
        t_in_process = sum(got.timings.values())
        del src
        _release()

        argv = ["--model-dir", str(model_dir), "--prompt", GEN_PROMPT, "--seed", str(GEN_SEED),
                "--steps", str(STEPS), "--frames", str(T), "--width", str(PX), "--height",
                str(PX), "--cfg-scale", str(CFG), "--outdir", str(root / "cli"), "--json"]
        if not files:
            argv.append("--skip-video-creation")
        _reset_counters()
        t0 = time.perf_counter()
        with _no_plain_on_cuda(), _no_frame_files(not files), _recording_infer() as results:
            generate.main(argv)
        t_cli = time.perf_counter() - t0
        launches["generate_cli"] = counts = _read_counters()
        if len(results) != 1 or counts != expected:
            _fail(f"generate: the CLI answered {len(results)} requests with launches {counts}, "
                  f"expected 1 with {expected}")
        _same_frames("generate: the CLI request", results[0].frames, want)
        tm = results[0].timings
        print(f"generate: CLI {t_cli:.3f} s for load, request and outputs; its request "
              f"{sum(tm.values()):.3f} s (text {tm['text']:.3f}, sample {tm['sample']:.3f}, "
              f"decode {tm['decode']:.3f}) against {t_in_process:.3f} s in process; "
              f"launches {counts}", flush=True)

        os.environ["T2V_MODELS_ROOT"] = str(root)
        srv = serve(port=0, block=False)
        host, port = srv.server_address
        query = (f"prompt={urllib.parse.quote(GEN_PROMPT)}&model=chip_smoke&seed={GEN_SEED}"
                 f"&steps={STEPS}&frames={T}&width={PX}&height={PX}&cfg_scale={CFG}")
        _reset_counters()
        t0 = time.perf_counter()
        with _no_plain_on_cuda(), _no_frame_files(not files), _recording_infer() as results:
            req = urllib.request.Request(f"http://{host}:{port}/t2v/run?{query}", data=b"",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, json.loads(r.read())
        t_api = time.perf_counter() - t0
        launches["generate_api"] = counts = _read_counters()
        if status != 200 or len(body["mp4s"]) != int(files) or len(results) != 1:
            _fail(f"generate: the API answered {status} with {len(body.get('mp4s', []))} "
                  f"videos and {len(results)} requests")
        if counts != expected:
            _fail(f"generate: API launches {counts}, expected {expected}")
        if results[0].frames is None or pl._PIPELINE_CACHE.get(
                ("modelscope", os.path.abspath(model_dir), torch.bfloat16, "cuda")) is not pipe:
            _fail("generate: the API request did not run on the cached pipeline")
        _same_frames("generate: the API request", results[0].frames, want)
        tm = results[0].timings
        print(f"generate: API {t_api:.3f} s a request over HTTP (its infer {sum(tm.values()):.3f} "
              f"s), {len(body['mp4s'][0]) if files else 0} bytes of data URL; launches {counts}",
              flush=True)

        mem = torch.cuda.memory_allocated()
        aux = _module_bytes(pipe.vae, pipe.text_encoder.model)
        frames, freed = [], []
        for i in range(2):
            _reset_counters()
            t0 = time.perf_counter()
            with _no_plain_on_cuda(), _no_frame_files(not files), _recording_infer() as results:
                run_mod.run(args, T2VOutputArgs(), pipe=pipe, outdir=str(root / "run"),
                            keep_in_vram="Main Model Only")
            t_run = time.perf_counter() - t0
            gc.collect()
            freed.append(mem - torch.cuda.memory_allocated())
            if pipe.vae is not None or pipe.text_encoder is not None or freed[-1] < aux:
                _fail(f"generate: 'Main Model Only' request {i} freed {freed[-1]} bytes, less "
                      f"than the VAE's and text tower's {aux}")
            if _read_counters() != expected:
                _fail(f"generate: 'Main Model Only' launches {_read_counters()}")
            frames.append(results[0].frames)
            print(f"generate: 'Main Model Only' request {i}: {t_run:.3f} s (reload included from "
                  f"the second), memory_allocated {mem / 2**30:.3f} -> "
                  f"{(mem - freed[-1]) / 2**30:.3f} GiB (VAE + text tower "
                  f"{aux / 2**30:.3f} GiB)", flush=True)
        for i, f in enumerate(frames):
            _same_frames(f"generate: 'Main Model Only' request {i}", f, want)

        # textual inversion and the tiled decode, on the same directory
        pipe.reload_aux()
        launches["generate_ti_cli"] = _ti_request(pipe, model_dir, root, files, expected)
        launches.update({f"generate_{k}": v for k, v in _tiled_decode(pipe).items()})
        del pipe
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if saved_root is None:
            os.environ.pop("T2V_MODELS_ROOT", None)
        else:
            os.environ["T2V_MODELS_ROOT"] = saved_root
        run_mod._warm_pipe = None
        pl._PIPELINE_CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)
        _release()
    return launches


TI_NAME = "zxq"  # the textual-inversion file's name, as a prompt writes it
TI_PROMPT = "a photo of zxq in the forest"
TILED_LATENT = (24, 72, 128, 4)  # ZeroScope's 1024x576, 24 frames
TILE, TILE_OVERLAP = 64, 16      # 4,096 mid-block tokens a tile: flash at D = 512
TILED_FRAME_RMS = 1e-2           # decoded frames, kernel against plain, relative RMS


def _hand_splice(tower, tokenizer, prompt: str, vec, device):
    """The conditioning of a one-chunk ``prompt`` naming ``TI_NAME``, built
    by hand: the name's ids replaced by ``len(vec)`` placeholder rows, BOS /
    EOS / zero padding, the token embeddings with ``vec`` written one place
    after the run (BOS comes first), the tower, the multiplier renorm with
    multipliers 1."""
    import torch

    from t2v_torch.text.encoder import weight_renorm

    ids, name = tokenizer.encode(prompt), tokenizer.encode(TI_NAME)
    at = next(i for i in range(len(ids)) if ids[i : i + len(name)] == name)
    ids = ids[:at] + [0] * len(vec) + ids[at + len(name):]
    toks = [tokenizer.bos_id] + ids + [tokenizer.eos_id] + [0] * (75 - len(ids))
    toks = torch.tensor([toks], device=device)
    with torch.no_grad():
        x = tower.token_embedding_weight[toks].clone()
        x[0, at + 1 : at + 1 + len(vec)] = vec.to(device, x.dtype)
        z = tower(toks, input_embeddings=x)
        return weight_renorm(z, torch.ones(toks.shape, device=device))


def _ti_request(pipe, model_dir: Path, root: Path, files: bool, expected: dict) -> dict:
    """A CLI request whose prompt names an A1111 ``.pt`` embedding (two
    seeded 1,024-wide rows) in ``--embeddings-dir``: its conditioning on the
    card against a float32 hand splice on the CPU (no further than
    SMALL_RATIO times the bf16 CPU splice's distance) and against the same
    splice on the card (equal), launch counts, and frames that differ from
    the same prompt without the file (``pipe``, which has none)."""
    import copy

    import numpy as np
    import torch

    from t2v_torch.cli import generate
    from t2v_torch.core.config import T2VArgs
    from t2v_torch.pipeline import run as run_mod

    g = torch.Generator().manual_seed(17)
    vec = torch.randn((2, pipe.clip_cfg.width), generator=g) * 0.02
    emb_dir = root / "embeddings"
    emb_dir.mkdir()
    torch.save({"string_to_token": {"*": 265}, "string_to_param": {"*": vec},
                "name": TI_NAME, "step": 1000}, emb_dir / f"{TI_NAME}.pt")
    argv = ["--model-dir", str(model_dir), "--embeddings-dir", str(emb_dir), "--prompt",
            TI_PROMPT, "--seed", str(GEN_SEED), "--steps", str(STEPS), "--frames", str(T),
            "--width", str(PX), "--height", str(PX), "--cfg-scale", str(CFG), "--outdir",
            str(root / "cli_ti"), "--skip-video-creation"]
    _reset_counters()
    t0 = time.perf_counter()
    with _no_plain_on_cuda(), _no_frame_files(not files), _recording_infer() as results:
        generate.main(argv)
    t_cli = time.perf_counter() - t0
    counts = _read_counters()
    if len(results) != 1 or counts != expected:
        _fail(f"TI: the CLI answered {len(results)} requests with launches {counts}, expected "
              f"1 with {expected}")
    ti_pipe, res = results.pipes[0], results[0]
    run_mod._warm_pipe = None
    enc = ti_pipe.text_encoder
    name_ids = enc.tokenizer.encode(TI_NAME)
    if enc.embedding_db.version != 1 or enc.embedding_db.find(name_ids, 0)[1] != len(name_ids):
        _fail("TI: the CLI did not register the embedding")
    got = enc.encode_line(TI_PROMPT)  # the request's own encoding, from the line cache
    on_card = _hand_splice(enc.model, enc.tokenizer, TI_PROMPT, vec, "cuda")[0]
    cpu32 = copy.deepcopy(enc.model).to("cpu", torch.float32)
    want = _hand_splice(cpu32, enc.tokenizer, TI_PROMPT, vec, "cpu")[0]
    cpu16 = _hand_splice(cpu32.to(torch.bfloat16), enc.tokenizer, TI_PROMPT, vec, "cpu")[0]
    del cpu32
    rel = lambda a, b: ((a.double().cpu() - b.double()).norm() / b.double().norm()).item()
    err, floor = rel(got, want), rel(cpu16, want)
    print(f"TI: CLI {t_cli:.3f} s (load, embedding, request); its conditioning {err:.3e} from "
          f"a float32 CPU hand splice (bf16 CPU splice {floor:.3e}, limit "
          f"{SMALL_RATIO * floor:.3e}), max |diff| to the card's hand splice "
          f"{(got.float() - on_card.float()).abs().max().item():.3e}; launches {counts}",
          flush=True)
    if err > SMALL_RATIO * floor or not torch.equal(got, on_card):
        _fail(f"TI: the card's conditioning is {err} from the hand splice (limit "
              f"{SMALL_RATIO * floor}) or differs from the card's own hand splice")
    del ti_pipe, enc, results
    _release()
    plain = _answer("TI: the same prompt without the embedding", pipe,
                    T2VArgs(prompt=TI_PROMPT, seed=GEN_SEED, steps=STEPS, frames=T, width=PX,
                            height=PX, cfg_scale=CFG), T, expected, STEPS)[1]
    if np.array_equal(plain.frames, res.frames):
        _fail("TI: the embedding did not change the frames")
    return counts


def _tiled_decode(pipe) -> dict:
    """A ZeroScope-sized latent (24 frames, 72 x 128) decoded on 64-pixel
    tiles with a 16-pixel overlap (6 tiles of 4,096 mid-block tokens a frame
    chunk: flash at D = 512) and untiled (9,216 tokens), timed with their
    peak memory; flash launches against the tile count. Both decodes' flash
    shapes are ``FLASH_CASES``, where ``check_flash`` holds the kernel on
    random inputs; here every flash call of both decodes is held against
    ``flash_attention_plain`` on the call's own inputs (``check_flash``'s
    limit), and a planted fault (flash leaving one 64-row query tile of
    each call at zero) must fail that check. The tiled and the untiled
    frames are also each held against the same decode with every attention
    on the plain path (``flash_takes`` barred)."""
    import numpy as np
    import torch

    from t2v_torch.kernels import attention as attention_mod
    from t2v_torch.kernels.flash_attention import flash_attention_plain
    from t2v_torch.models.vae_tiled import _tile_starts
    from t2v_torch.pipeline.pipeline import _spatial_scale, decode_chunk_frames

    f, h, w, _ = TILED_LATENT
    up = _spatial_scale(pipe.vae_cfg)
    step_f = decode_chunk_frames(f, h * up, w * up)
    chunks = -(-f // step_f)
    tiles = (len(_tile_starts(h, TILE, TILE - TILE_OVERLAP))
             * len(_tile_starts(w, TILE, TILE - TILE_OVERLAP)))
    for n in (TILE * TILE, h * w):
        if (step_f, n, n, 512, 512 ** -0.5) not in FLASH_CASES:
            _fail(f"tiled decode: flash shape {(step_f, n, n, 512)} is not in FLASH_CASES")
    g = torch.Generator(device="cuda").manual_seed(9)
    z = torch.randn(TILED_LATENT, generator=g, device="cuda")
    flash = attention_mod.flash_attention

    def missed_query_tile(q, k, v, scale=None):
        out = flash(q, k, v, scale).clone()
        mid = q.shape[1] // 2  # the tile's middle row: full weight in the blend
        out[:, mid : mid + 64] = 0
        return out

    def decode(label, tile, attn: str, record: bool = False):
        """Frames, launch counts and, with ``record``, the flash calls'
        inputs and outputs (copies that add to the peak memory)."""
        calls = []

        def recorded(q, k, v, scale=None):
            out = (missed_query_tile if attn == "fault" else flash)(q, k, v, scale)
            calls.append((q.clone(), k.clone(), v.clone(), scale, out.clone()))
            return out

        pipe.decode_tile, pipe.decode_tile_overlap = tile, TILE_OVERLAP
        takes = attention_mod.flash_takes
        if attn == "plain":
            attention_mod.flash_takes = lambda q: False
        elif record:
            attention_mod.flash_attention = recorded
        _release()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        _reset_counters()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (_no_plain_on_cuda() if attn == "kernels" else contextlib.nullcontext()):
                frames = pipe.decode_latents(z)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            attention_mod.flash_takes, attention_mod.flash_attention = takes, flash
            pipe.decode_tile = None
        counts = _read_counters()
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        print(f"tiled decode: {label}: {dt:.3f} s, peak {peak:.2f} GiB above the resident "
              f"weights, frames {frames.shape}, flash launches {counts['flash_attention']}",
              flush=True)
        if frames.shape != (f, h * up, w * up, 3) or frames.dtype != np.uint8:
            _fail(f"tiled decode: {label}: frames {frames.shape} {frames.dtype}")
        return frames, counts, calls

    def calls_err(label, calls) -> float:
        """The largest |kernel - plain| of the calls over its limit."""
        worst = 0.0
        for q, k, v, scale, got in calls:
            want = flash_attention_plain(q, k, v, scale).float()
            err = (got.float() - want).abs().max().item()
            worst = max(worst, err / (TOL_SHARE * max(1.0, want.abs().max().item())))
        print(f"tiled decode: {label}: {len(calls)} flash calls {tuple(calls[0][0].shape)} on "
              f"their own inputs, the largest error {worst:.3f} of the limit "
              f"({TOL_SHARE:.0%} of max |out|)", flush=True)
        calls.clear()
        return worst

    def frame_err(label, got, want) -> float:
        a, b = got.astype(np.float64), want.astype(np.float64)
        err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        print(f"tiled decode: {label}: {err:.3e} relative RMS from the plain path's frames "
              f"(limit {TILED_FRAME_RMS:.0e}), max {int(np.abs(a - b).max())} levels",
              flush=True)
        return err

    out, frames, plain = {}, {}, {}
    for label, tile, want in ((f"tiled {TILE}/{TILE_OVERLAP}", TILE, chunks * tiles),
                              ("untiled", None, chunks)):
        frames[tile], counts, _ = decode(f"{label}, kernels", tile, "kernels")
        out[f"{label}, kernels"] = counts
        if counts != {**{k: 0 for k in counts}, "flash_attention": want}:
            _fail(f"{label} decode: launches {counts}, expected {want} flash launches "
                  f"({chunks} chunks) and nothing else")
        again, _, calls = decode(f"{label}, kernels, flash calls recorded", tile, "kernels",
                                 record=True)
        if len(calls) != want or not np.array_equal(again, frames[tile]):
            _fail(f"{label} decode: {len(calls)} flash calls recorded, expected {want}, or "
                  f"the recorded decode's frames differ")
        if calls_err(f"{label}, kernel", calls) > 1.0:
            _fail(f"{label} decode: a flash call is further from its plain version than "
                  f"{TOL_SHARE:.0%} of max |out|")
        plain[tile], counts, _ = decode(f"{label}, plain attention", tile, "plain")
        if any(counts.values()):
            _fail(f"{label} decode: the plain attention launched kernels: {counts}")
        if frame_err(f"{label}, kernel", frames[tile], plain[tile]) > TILED_FRAME_RMS:
            _fail(f"{label} decode: the kernel's frames are more than {TILED_FRAME_RMS} from "
                  f"the plain path's")
    fault, _, calls = decode(f"tiled {TILE}/{TILE_OVERLAP}, planted fault", TILE, "fault",
                             record=True)
    if calls_err("planted fault (a 64-row query tile left at zero)", calls) <= 1.0:
        _fail("tiled decode: the per-call check passes a flash that skips a query tile")
    frame_err("planted fault, frames (reported: the frame check is not the kernel's)", fault,
              plain[TILE])
    print(f"tiled decode: tiled against untiled mean "
          f"{np.abs(frames[TILE].astype(np.float64) - frames[None]).mean():.2f} levels "
          f"({chunks} chunks x {tiles} tiles)", flush=True)
    return out


VC_NAME = "chip_smoke_vc"
VC_LORA_RANK, VC_LORA_ALPHA = 4, 0.75


def _on(results, pipe) -> bool:
    """Whether ``results`` holds one request, answered by ``pipe``."""
    return len(results.pipes) == 1 and results.pipes[0] is pipe


def _write_vc_dir(pipe, out: Path) -> int:
    """A VideoCrafter directory in the published layout from ``pipe``: a
    float32 Lightning ``model.ckpt`` (``convert_vc.lightning_state_dict``
    under ``state_dict``), ``model_config.yaml`` (``base_t2v_yaml``) and the
    vocab. Returns the bytes written."""
    import shutil

    import torch

    from t2v_torch.io.convert_vc import base_t2v_yaml, lightning_state_dict

    out.mkdir(parents=True)
    (out / "model_config.yaml").write_text(base_t2v_yaml(pipe.cfg, pipe.vae_cfg, VC_T))
    torch.save({"state_dict": lightning_state_dict(pipe.unet, pipe.vae, pipe.clip),
                "global_step": 0, "epoch": 0}, out / "model.ckpt")
    shutil.copy(VOCAB, out / "bpe_simple_vocab_16e6.txt.gz")
    return sum(f.stat().st_size for f in out.iterdir())


def _vc_lora_file(pipe, path: Path) -> dict:
    """A seeded rank-4 LVDM LoRA over every target of the UNet's index,
    written as .safetensors; returns its float32 factors."""
    import torch

    from t2v_torch.io.convert_vc import vc_module_index
    from t2v_torch.io.safetensors_io import save_safetensors

    g = torch.Generator().manual_seed(29)
    params = pipe.unet.state_dict()
    sd = {}
    for name, (pname, _) in vc_module_index(pipe.cfg).items():
        d_out, d_in = params[pname].shape
        sd[f"{name}.lora_up.weight"] = torch.randn((d_out, VC_LORA_RANK), generator=g) * 0.05
        sd[f"{name}.lora_down.weight"] = torch.randn((VC_LORA_RANK, d_in), generator=g) * 0.05
    save_safetensors(str(path), {k: v.numpy() for k, v in sd.items()})
    return sd


def _check_lvdm_merge(merged, base: dict, lora: dict, cfg) -> None:
    """Every LoRA target of ``merged`` (a UNet on the card) against
    ``W + alpha * up @ down`` computed on the CPU from the unmerged bf16
    ``base``, within one bf16 rounding step; every other tensor unchanged."""
    import torch

    from t2v_torch.io.convert_vc import vc_module_index

    got = merged.state_dict()
    targets = {pname: name for name, (pname, _) in vc_module_index(cfg).items()}
    worst, exact = 0.0, 0
    for pname, w in base.items():
        g = got[pname].cpu()
        if pname not in targets:
            if not torch.equal(g, w):
                _fail(f"LVDM LoRA: {pname} changed, and it is no target")
            continue
        name = targets[pname]
        delta = (lora[f"{name}.lora_up.weight"] @ lora[f"{name}.lora_down.weight"]) * VC_LORA_ALPHA
        want = (w.float() + delta).to(torch.bfloat16).float()
        diff = (g.float() - want).abs()
        worst = max(worst, (diff / want.abs().clamp_min(1e-30)).max().item())
        exact += torch.equal(g.float(), want)
        if (diff > want.abs() * 2.0 ** -7).any():
            _fail(f"LVDM LoRA: {pname} is more than one bf16 step from W + alpha up@down")
    print(f"LVDM LoRA: {len(targets)} targets merged as W + {VC_LORA_ALPHA} up@down (rank "
          f"{VC_LORA_RANK}), {exact} of them bit-identical to the CPU sum, the largest "
          f"relative difference {worst:.2e}; every other tensor unchanged", flush=True)


def drive_vcgenerate() -> dict:
    """VideoCrafter from a published directory to an mp4: write a
    full-width ``model.ckpt`` + ``model_config.yaml`` + vocab from a seeded
    bf16 pipeline (``os.sync()`` after), load it with ``load_vc_pipeline``
    (every tensor bit-identical to the source's bf16), answer the 16-frame
    request in process, through ``run`` by name, through ``cli.generate
    --model-type VideoCrafter --model-dir`` and through one HTTP API request
    (identical frames, launch counts); the CLI again with a seeded rank-4
    LVDM ``--lora`` (merged weights against the CPU sum, frames changed);
    a 'Main Model Only' pair through ``run`` (``release_aux`` frees the
    VAE's and CLIP-L's bytes, identical frames after the reload). Returns
    the launches of each path."""
    import os
    import shutil
    import tempfile
    import urllib.parse
    import urllib.request

    import numpy as np
    import torch

    from t2v_torch.api.stdlib_server import serve
    from t2v_torch.cli import generate
    from t2v_torch.core.config import CLIPTextConfig, T2VArgs, T2VOutputArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites
    from t2v_torch.pipeline import pipeline as pl
    from t2v_torch.pipeline import run as run_mod
    from t2v_torch.pipeline import videocrafter as vc
    from t2v_torch.text.tokenizer import CLIPTokenizer

    try:
        import cv2  # noqa: F401
        files = True
    except ImportError:
        files = False
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_vc_", dir=REPO))
    launches, srv, saved_root = {}, None, os.environ.get("T2V_MODELS_ROOT")
    try:
        src = vc.VideoCrafterPipeline.random_init(
            policy=Policy.bf16(), seed=5, device="cuda", clip_cfg=CLIPTextConfig.clip_l_14())
        _perturb_zero_leaves(src)
        src.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
        model_dir = root / "text2video" / VC_NAME
        t0 = time.perf_counter()
        nbytes = _write_vc_dir(src, model_dir)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()
        t_sync = time.perf_counter() - t0

        _release()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = vc.load_vc_pipeline(str(model_dir))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        n = _same_weights(pipe, src)
        print(f"vcgenerate: wrote {nbytes / 1e9:.3f} GB (model.ckpt, model_config.yaml, vocab) in "
              f"{t_write:.2f} s (then os.sync {t_sync:.2f} s); load_vc_pipeline {t_load:.2f} s "
              f"({nbytes / 1e9 / t_load:.2f} GB/s), "
              f"{(torch.cuda.memory_allocated() - mem0) / 2**30:.3f} GiB on the card; {n} tensors "
              f"bit-identical to the source's bf16; CLIP-L {pipe.clip_cfg.layers} layers, "
              f"{pipe.clip_cfg.vocab_size} rows", flush=True)

        expected = _expected(count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT), VC_STEPS, 1)
        args = T2VArgs(prompt=GEN_PROMPT, seed=GEN_SEED, steps=VC_STEPS, frames=VC_T, width=PX,
                       height=PX, cfg_scale=CFG, model_type="VideoCrafter", model=VC_NAME)
        want = _answer("vcgenerate: source pipeline 16f", src, args, VC_T, expected,
                       VC_STEPS)[1].frames
        got = _answer("vcgenerate: loaded pipeline 16f", pipe, args, VC_T, expected, VC_STEPS)[1]
        _same_frames("vcgenerate: the loaded pipeline", got.frames, want)
        t_in_process = sum(got.timings.values())
        del src
        _release()

        os.environ["T2V_MODELS_ROOT"] = str(root)
        _reset_counters()
        t0 = time.perf_counter()
        with _no_plain_on_cuda(), _no_frame_files(not files), \
                _recording_infer(vc.VideoCrafterPipeline) as results:
            run_mod.run(args, T2VOutputArgs(), outdir=str(root / "run"))
        t_run = time.perf_counter() - t0
        launches["vcgenerate_run"] = counts = _read_counters()
        if not _on(results, pipe) or counts != expected:
            _fail(f"vcgenerate: run answered {len(results)} requests (on the cached pipeline: "
                  f"{_on(results, pipe)}) with launches {counts}, expected {expected}")
        _same_frames("vcgenerate: run by name", results[0].frames, want)
        print(f"vcgenerate: run by name {t_run:.3f} s (request and outputs) against "
              f"{t_in_process:.3f} s in process; launches {counts}", flush=True)

        cli_argv = ["--model-type", "VideoCrafter", "--prompt", GEN_PROMPT, "--seed",
                    str(GEN_SEED), "--steps", str(VC_STEPS), "--frames", str(VC_T), "--width",
                    str(PX), "--height", str(PX), "--cfg-scale", str(CFG), "--json"]
        if not files:
            cli_argv.append("--skip-video-creation")
        for label, extra in (("CLI", ["--model-dir", str(model_dir)]),
                             ("CLI with an LVDM LoRA", [
                                 "--model-dir", str(model_dir / "model.ckpt"), "--lora",
                                 str(root / "lvdm_lora.safetensors"), "--lora-alpha",
                                 str(VC_LORA_ALPHA)])):
            lora = _vc_lora_file(pipe, root / "lvdm_lora.safetensors") if "--lora" in extra \
                else None
            _reset_counters()
            t0 = time.perf_counter()
            with _no_plain_on_cuda(), _no_frame_files(not files), \
                    _recording_infer(vc.VideoCrafterPipeline) as results:
                generate.main([*cli_argv, *extra, "--outdir", str(root / label.replace(" ", "_"))])
            t_cli = time.perf_counter() - t0
            key = "vcgenerate_cli_lora" if lora else "vcgenerate_cli"
            launches[key] = counts = _read_counters()
            if len(results) != 1 or counts != expected:
                _fail(f"vcgenerate: the {label} answered {len(results)} requests with launches "
                      f"{counts}, expected 1 with {expected}")
            tm = results[0].timings
            print(f"vcgenerate: {label} {t_cli:.3f} s for load, request and outputs; its "
                  f"request {sum(tm.values()):.3f} s (text {tm['text']:.3f}, sample "
                  f"{tm['sample']:.3f}, decode {tm['decode']:.3f}); launches {counts}",
                  flush=True)
            if lora is None:
                _same_frames("vcgenerate: the CLI request", results[0].frames, want)
            else:
                base = {k: v.cpu() for k, v in pipe.unet.state_dict().items()}
                _check_lvdm_merge(results.pipes[0].unet, base, lora, pipe.cfg)
                del base
                if np.array_equal(results[0].frames, want):
                    _fail("vcgenerate: the LVDM LoRA did not change the frames")
            del results
            run_mod._warm_pipe = None
            _release()

        srv = serve(port=0, block=False)
        host, port = srv.server_address
        query = (f"prompt={urllib.parse.quote(GEN_PROMPT)}&model_type=VideoCrafter"
                 f"&model={VC_NAME}&seed={GEN_SEED}&steps={VC_STEPS}&frames={VC_T}&width={PX}"
                 f"&height={PX}&cfg_scale={CFG}")
        _reset_counters()
        t0 = time.perf_counter()
        with _no_plain_on_cuda(), _no_frame_files(not files), \
                _recording_infer(vc.VideoCrafterPipeline) as results:
            req = urllib.request.Request(f"http://{host}:{port}/t2v/run?{query}", data=b"",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, json.loads(r.read())
        t_api = time.perf_counter() - t0
        launches["vcgenerate_api"] = counts = _read_counters()
        if status != 200 or len(body["mp4s"]) != int(files) or not _on(results, pipe):
            _fail(f"vcgenerate: the API answered {status} with {len(body.get('mp4s', []))} "
                  f"videos, {len(results)} requests (on the cached pipeline: "
                  f"{_on(results, pipe)})")
        if counts != expected:
            _fail(f"vcgenerate: API launches {counts}, expected {expected}")
        _same_frames("vcgenerate: the API request", results[0].frames, want)
        tm = results[0].timings
        print(f"vcgenerate: API {t_api:.3f} s a request over HTTP (its infer "
              f"{sum(tm.values()):.3f} s); launches {counts}", flush=True)
        del results

        mem = torch.cuda.memory_allocated()
        aux = _module_bytes(pipe.vae, pipe.clip)
        frames, freed = [], []
        for i in range(2):
            _reset_counters()
            t0 = time.perf_counter()
            with _no_plain_on_cuda(), _no_frame_files(not files), \
                    _recording_infer(vc.VideoCrafterPipeline) as results:
                run_mod.run(args, T2VOutputArgs(), outdir=str(root / "mmo"),
                            keep_in_vram="Main Model Only")
            t_run = time.perf_counter() - t0
            gc.collect()
            freed.append(mem - torch.cuda.memory_allocated())
            if pipe.vae is not None or pipe.clip is not None or freed[-1] < aux:
                _fail(f"vcgenerate: 'Main Model Only' request {i} freed {freed[-1]} bytes, less "
                      f"than the VAE's and CLIP-L's {aux}")
            if _read_counters() != expected or not _on(results, pipe):
                _fail(f"vcgenerate: 'Main Model Only' launches {_read_counters()}")
            frames.append(results[0].frames)
            del results
            print(f"vcgenerate: 'Main Model Only' request {i}: {t_run:.3f} s (reload included "
                  f"from the second), memory_allocated {mem / 2**30:.3f} -> "
                  f"{(mem - freed[-1]) / 2**30:.3f} GiB (VAE + CLIP-L {aux / 2**30:.3f} GiB)",
                  flush=True)
        for i, f in enumerate(frames):
            _same_frames(f"vcgenerate: 'Main Model Only' request {i}", f, want)
        del pipe
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if saved_root is None:
            os.environ.pop("T2V_MODELS_ROOT", None)
        else:
            os.environ["T2V_MODELS_ROOT"] = saved_root
        run_mod._warm_pipe = None
        pl._PIPELINE_CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)
        _release()
    return launches


# ---------------------------------------------------------------------------
# VideoCrafter's other branches (``--only vcbranches``; the full-width DDPM
# chain alone in ``--only vcddpm``)

VCB_ARGS = dict(prompt="a photo of a cat in the forest", n_prompt="blurry", seed=1234,
                steps=VC_STEPS, frames=VC_T, width=PX, height=PX, cfg_scale=CFG)
VCB_FPS_NAME = "chip_smoke_vc_fps"
VCB_INPAINT_FRAMES = 4   # keyframes of the inpainting request: frame 0 keeps the source
VCB_WINDOW = 5           # callback interval of the windowed requests
SMALL_DDPM_T = 10        # timesteps of the small DDPM chain (its whole chain)
SMALL_DEPTH = dict(frames=2, adapter_frames=4)
MASKED_SHAPE = (2, VC_T, 1024, 8, 40)  # (B, T, N, H, D): the top level of the VC UNet


def _differ(label, a, b) -> None:
    import numpy as np

    if np.array_equal(a, b):
        _fail(f"{label}: the frames are identical")


def _check_small_ddpm() -> dict:
    """The DDPM chain on the small VideoCrafter pipeline (its config with
    ``SMALL_DDPM_T`` timesteps, so the whole chain is that many steps, CFG
    9), bf16 on the card against float32 on the CPU with the same starting
    latent and injected step noise. The chain amplifies every difference
    from step to step, so the gate is taken step by step: each step's
    guided eps from the float32 chain's own state, on the three pipelines,
    under SMALL_RATIO; then the card runs the whole chain through ``infer``
    (finite, its distance from the float32 chain printed)."""
    import dataclasses

    import torch

    from t2v_torch.core.config import T2VArgs, VideoCrafterUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.diffusion import ddpm
    from t2v_torch.diffusion.sampling import make_eps_fn
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    cfg = dataclasses.replace(VideoCrafterUNetConfig(**SMALL_VC_UNET), num_timesteps=SMALL_DDPM_T)
    args = T2VArgs(prompt="a red fox running in the snow", n_prompt="blurry", seed=3, steps=4,
                   frames=4, width=64, height=64, cfg_scale=CFG)
    g = torch.Generator().manual_seed(5)
    shape = (1, 4, 32, 32, 4)
    noise = torch.randn(shape, generator=g)
    table = [torch.randn(shape, generator=g) for _ in range(SMALL_DDPM_T)]
    build = lambda policy, dev: VideoCrafterPipeline.random_init(  # noqa: E731
        cfg, policy, seed=0, device=dev, small_aux=True)
    ref = build(Policy.fp32(), "cpu")
    _perturb_zero_leaves(ref)
    pipes = {"f32": ref, "cpu16": _copied(build, ref, Policy.bf16(), "cpu"),
             "card": _copied(build, ref, Policy.bf16(), "cuda")}

    def guided(pipe):
        cond, uncond = pipe.encode_text([args.prompt]), pipe.encode_text([args.n_prompt])
        return make_eps_fn(pipe.make_apply_fn(), cond, uncond, args.cfg_scale, "full",
                           pipe.cfg.parameterization, pipe.schedule)

    with torch.no_grad():
        fns = {k: guided(p) for k, p in pipes.items()}
        states = []

        def recording(x, t, i):
            states.append((x.clone(), t, i))
            return fns["f32"](x, t, i)

        t0 = time.perf_counter()
        want = ddpm.sample(recording, ref.schedule, noise, noise_table=table, clip_denoised=False)
        eps = {k: [] for k in pipes}
        _reset_counters()
        for x, t, i in states:
            for k, p in pipes.items():
                eps[k].append(fns[k](x.to(p.device), t, i).float().cpu())
        torch.cuda.synchronize()
        launches = _read_counters()
        t_steps = time.perf_counter() - t0
    label = f"small VideoCrafter DDPM (T = {SMALL_DDPM_T}, the whole chain)"
    _within_ratio(f"{label}: every step's eps on the float32 chain's state",
                  *(torch.stack(eps[k]) for k in ("card", "cpu16", "f32")))
    t0 = time.perf_counter()
    res = pipes["card"].infer(args, noise=noise, sample_type="ddpm", ddpm_noise=table)
    t_card = time.perf_counter() - t0
    lat = res.latents.cpu()
    if not torch.isfinite(lat).all():
        _fail(f"{label}: the card's chain is not finite")
    print(f"{label}: the card's whole chain {t_card:.2f} s, its latents "
          f"{((lat - want).norm() / want.norm()).item():.3e} from the float32 chain's (relative "
          f"RMS; the chain carries each step's difference into the next); the per-step pass "
          f"{t_steps:.2f} s with launches {launches}", flush=True)
    if not all(launches[k] for k in ("flash_attention", "fused_self_mha", "fused_cross_mha",
                                     "relpos_mha")):
        _fail(f"{label}: a kernel of the path did not run: {launches}")
    return launches


def _check_small_depth_adapter() -> None:
    """A tiny MidasSmall (BatchNorms folded, as the loader does) and a
    tiny depth-layout Adapter in bf16 on the card against float32 on the
    CPU, under the small pipelines' rule (at most SMALL_RATIO times as far
    from float32 as bf16 on the CPU)."""
    import torch

    from t2v_torch.models.adapter import Adapter, AdapterConfig
    from t2v_torch.models.depth import MidasSmall, MidasSmallConfig
    from t2v_torch.pipeline.pipeline import init_weights

    g = torch.Generator().manual_seed(11)
    midas = MidasSmall(MidasSmallConfig().tiny()).eval()
    init_weights(midas, 7)
    with torch.no_grad():
        for name, b in midas.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=g)
            elif name.endswith("running_mean"):
                b.normal_(0.0, 0.5, generator=g)
    midas.fold_batchnorm()
    adapter = Adapter(AdapterConfig(channels=(64, 128, 256, 256), nums_rb=2, ksize=1, sk=True,
                                    use_conv=False)).eval()
    init_weights(adapter, 8)
    frames = torch.rand((SMALL_DEPTH["frames"], 384, 384, 3), generator=g) * 2 - 1
    depth = torch.rand((SMALL_DEPTH["adapter_frames"], 256, 256, 1), generator=g) * 2 - 1
    for label, module, x in (("MidasSmall (tiny)", midas, frames),
                             ("Adapter (tiny, depth layout)", adapter, depth)):
        with torch.no_grad():
            want = module(x)
            cpu16 = [module.to(torch.bfloat16)(x)]
            got = module.cuda()(x.cuda())
            module.float().cpu()
        want, cpu16, got = (o if isinstance(o, tuple) else (o,) for o in (want, cpu16[0], got))
        for i, (a, b, c) in enumerate(zip(got, cpu16, want)):
            if not torch.isfinite(a).all():
                _fail(f"{label}: output {i} is not finite on the card")
            _within_ratio(f"{label} output {i} {tuple(c.shape)}", a.float(), b.float(), c)


def _check_masked_temporal_attention() -> None:
    """One masked temporal-attention call (a causal frame mask) in bf16 on
    the card at the VideoCrafter UNet's top level: no rel-pos launch (the
    dispatch sends a masked call to the plain version), and within
    TOL_SHARE of the float32 CPU run on the same inputs; the mask changes
    the output."""
    import torch

    from t2v_torch.kernels.attention import relpos_attention

    b, t, n, h, d = MASKED_SHAPE
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn((b * t, n, h * d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    k2, v2 = (torch.randn((t, t, d), generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    mask = torch.tril(torch.ones((t, t), device="cuda"))
    _reset_counters()
    t0 = time.perf_counter()
    got = relpos_attention(q, k, v, k2, v2, h, t, d ** -0.5, mask=mask)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _read_counters()
    if counts["relpos_mha"]:
        _fail(f"masked temporal attention: the rel-pos kernel ran ({counts})")
    cpu = [x.float().cpu() for x in (q, k, v, k2, v2)]
    want = relpos_attention(*cpu, h, t, d ** -0.5, mask=mask.cpu())
    rec = KernelRecord("masked relpos_mha", "", "", "")
    _compare(rec, f"{tuple(q.shape)} heads={h} causal mask (plain on the card)", got.cpu(), want)
    free = relpos_attention(*cpu, h, t, d ** -0.5)
    if torch.equal(free, want):
        _fail("masked temporal attention: the mask changed nothing")
    print(f"masked temporal attention: {ms:.1f} ms on the card through the plain version, "
          f"launches {counts}", flush=True)


def _write_depth_inputs(root: Path) -> tuple[Path, Path, Path]:
    """The depth adapter's three files at full size from seeds: the
    published depth adapter (``AdapterConfig.depth_adapter()``, 77.0M
    parameters) as a float32 ``.pth`` under ``state_dict`` with the
    ``adapter.`` prefix; ``midas_v21_small`` (``MidasSmallConfig()``, with
    BatchNorm statistics) as a float32 ``.pt``; a 16-frame 256x256 RGB mp4
    (cv2's mp4v writer) of a moving seeded pattern."""
    import cv2
    import numpy as np
    import torch

    from t2v_torch.models.adapter import Adapter, AdapterConfig
    from t2v_torch.models.depth import MidasSmall
    from t2v_torch.pipeline.pipeline import init_weights

    adapter = Adapter(AdapterConfig.depth_adapter())
    init_weights(adapter, 31)
    adapter_path = root / "adapter_depth.pth"
    torch.save({"state_dict": {f"adapter.{k}": v for k, v in adapter.state_dict().items()}},
               adapter_path)
    midas = MidasSmall()
    init_weights(midas, 32)
    g = torch.Generator().manual_seed(33)
    with torch.no_grad():
        for name, b in midas.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=g)
            elif name.endswith("running_mean"):
                b.normal_(0.0, 0.5, generator=g)
    midas_path = root / "midas_v21_small.pt"
    torch.save(midas.state_dict(), midas_path)
    video = root / "depth_source.mp4"
    rng = np.random.default_rng(34)
    base = cv2.resize(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), (2 * PX, 2 * PX),
                      interpolation=cv2.INTER_CUBIC)
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 8, (PX, PX))
    for i in range(VC_T):
        writer.write(base[4 * i:4 * i + PX, 6 * i:6 * i + PX])
    writer.release()
    return adapter_path, midas_path, video


def drive_vcbranches() -> dict:
    """VideoCrafter's other branches at full width (the 0.959B UNet, CLIP-L
    at 49,408 rows, the SD VAE; bf16; 16 frames at 256x256, 20 steps, CFG
    9): first the small checks (the DDPM chain on the small pipeline, a tiny
    MidasSmall and Adapter, one masked temporal-attention call), then the
    default DDIM request and the ``uc_type`` variants, DPM++ 2M whole and
    windowed by a callback, LVDM mask inpainting through ``run``, an
    FPS-conditioned model written as a Lightning ``model.ckpt`` and loaded
    through ``load_vc_pipeline`` (8 and 24 frames a second, and none), and
    the depth adapter with MiDaS from files through ``run`` and the CLI.
    Every request counts its launches against the topology's, with the
    plain versions barred from CUDA tensors. Returns the launches of each
    path."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import cv2
    import numpy as np
    import torch

    from t2v_torch.cli import generate
    from t2v_torch.core.config import CLIPTextConfig, T2VArgs, T2VOutputArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.io.convert_vc import base_t2v_yaml, lightning_state_dict
    from t2v_torch.media.video import vid2frames
    from t2v_torch.models.adapter import AdapterConfig
    from t2v_torch.models.depth import DepthStage
    from t2v_torch.models.videocrafter_unet import FPSEmbedder, count_vc_kernel_sites
    from t2v_torch.pipeline import pipeline as pl
    from t2v_torch.pipeline import run as run_mod
    from t2v_torch.pipeline import videocrafter as vc
    from t2v_torch.pipeline.pipeline import init_weights
    from t2v_torch.text.tokenizer import CLIPTokenizer

    launches = {"vcbranches_small_ddpm": _check_small_ddpm()}
    _check_small_depth_adapter()
    _check_masked_temporal_attention()
    _release()

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_vcb_", dir=REPO))
    saved_root = os.environ.get("T2V_MODELS_ROOT")
    try:
        t0 = time.perf_counter()
        pipe = vc.VideoCrafterPipeline.random_init(
            policy=Policy.bf16(), seed=0, device="cuda", clip_cfg=CLIPTextConfig.clip_l_14())
        _perturb_zero_leaves(pipe)
        pipe.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
        torch.cuda.synchronize()
        print(f"vcbranches: full-width pipeline {time.perf_counter() - t0:.1f} s, UNet "
              f"{sum(p.numel() for p in pipe.unet.parameters()) / 1e9:.3f}B params, CLIP-L "
              f"{pipe.clip_cfg.vocab_size} rows", flush=True)
        per_call = count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT)
        expected = _expected(per_call, VC_STEPS, 1)
        args = T2VArgs(**VCB_ARGS)

        def answer(label, p, a, **kw):
            return _answer(f"vcbranches: {label}", p, a, VC_T, expected, VC_STEPS, **kw)

        launches["vcbranches_ddim"], base = answer("DDIM (default)", pipe, args)
        uc = {}
        for uc_type in ("cfg_original", "cfg_ours"):
            launches[f"vcbranches_{uc_type}"], uc[uc_type] = answer(
                f"DDIM uc_type {uc_type}", pipe, args, uc_type=uc_type)
            _differ(f"vcbranches: {uc_type} against the default", uc[uc_type].frames,
                    base.frames)
        _differ("vcbranches: cfg_original against cfg_ours", uc["cfg_original"].frames,
                uc["cfg_ours"].frames)
        del uc

        launches["vcbranches_dpmpp"], whole = answer("DPM++ 2M", pipe, args,
                                                     sample_type="dpm++ 2m")
        done = []
        launches["vcbranches_dpmpp_windowed"], windowed = answer(
            f"DPM++ 2M windowed (callback every {VCB_WINDOW} steps)", pipe, args,
            sample_type="dpm++ 2m", callback=done.append, callback_interval=VCB_WINDOW)
        if done != list(range(VCB_WINDOW, VC_STEPS + 1, VCB_WINDOW)):
            _fail(f"vcbranches: the windowed DPM++ 2M request called back at {done}")
        if not torch.equal(windowed.latents, whole.latents):
            _fail("vcbranches: the windowed DPM++ 2M latents differ from the whole loop's")
        print(f"vcbranches: windowed DPM++ 2M latents bit-identical to the whole loop's "
              f"(callbacks at {done})", flush=True)
        del whole, windowed

        # LVDM mask inpainting through run, from a seeded 256x256 image
        image = root / "inpaint_source.png"
        rgb = cv2.resize(np.random.default_rng(35).integers(0, 255, (32, 32, 3), dtype=np.uint8),
                         (PX, PX), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(image), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        iargs = args.replace(inpainting_frames=VCB_INPAINT_FRAMES, inpainting_image=str(image))
        encodes = -(-VC_T // pl.DECODE_CHUNK)
        inpaint_expected = dict(expected, flash_attention=expected["flash_attention"] + encodes)
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        t0 = time.perf_counter()
        with _no_plain_on_cuda(), _recording_infer(vc.VideoCrafterPipeline) as results:
            run_mod.run(iargs, T2VOutputArgs(), pipe=pipe, outdir=str(root / "inpaint"))
        t_run = time.perf_counter() - t0
        launches["vcbranches_inpaint_run"] = counts = _read_counters()
        if len(results) != 1 or counts != inpaint_expected:
            _fail(f"vcbranches: inpainting through run answered {len(results)} requests with "
                  f"launches {counts}, expected {inpaint_expected} ({encodes} encode calls)")
        # the kept frame (mask 1) is the source re-noised to t = 0 by the last
        # step's blend: sqrt(abar_0) * source + sqrt(1 - abar_0) * a N(0, 1) draw
        img = cv2.cvtColor(cv2.imread(str(image)), cv2.COLOR_BGR2RGB)
        mask, src = pipe.build_inpainting_inputs(img, iargs)
        kept = mask[0, :, 0, 0, 0] == 1
        sa = float(pipe.schedule.sqrt_alphas_cumprod[0])
        s1ma = float(pipe.schedule.sqrt_one_minus_alphas_cumprod[0])
        lat = results[0].latents
        draw = (lat[0, kept] - sa * src[0, kept]) / s1ma
        rms = draw.pow(2).mean().sqrt().item()
        moved = (lat[0, ~kept] - src[0, ~kept]).abs().mean().item()
        print(f"vcbranches: inpainting through run {t_run:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts}; keep "
              f"weights {[round(x, 3) for x in mask[0, :, 0, 0, 0].tolist()[:5]]}...; kept "
              f"frame(s) {kept.nonzero().flatten().tolist()} = sqrt(abar_0) source + "
              f"{s1ma:.4f} x a draw of RMS {rms:.3f}; the other frames' mean distance from "
              f"the source {moved:.3f}", flush=True)
        if not 0.9 < rms < 1.1 or moved < 10 * s1ma:
            _fail(f"vcbranches: the kept frames do not hold the source (draw RMS {rms}, "
                  f"other frames {moved})")
        del results, lat, src, mask
        run_mod._warm_pipe = None

        # an FPS-conditioned model from a Lightning model.ckpt
        fps_cfg = dataclasses.replace(pipe.cfg, cond_stage2_key="temporal_context")
        with torch.device("cuda"):
            fps = FPSEmbedder(pipe.cfg.model_channels)
        init_weights(fps, 36)
        fps = fps.to(torch.bfloat16)
        model_dir = root / "text2video" / VCB_FPS_NAME
        model_dir.mkdir(parents=True)
        t0 = time.perf_counter()
        (model_dir / "model_config.yaml").write_text(base_t2v_yaml(fps_cfg, pipe.vae_cfg, VC_T))
        torch.save({"state_dict": lightning_state_dict(pipe.unet, pipe.vae, pipe.clip, fps),
                    "global_step": 0, "epoch": 0}, model_dir / "model.ckpt")
        shutil.copy(VOCAB, model_dir / "bpe_simple_vocab_16e6.txt.gz")
        os.sync()
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        fpipe = vc.load_vc_pipeline(str(model_dir))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(fpipe.fps_embedder.state_dict().values(),
                                                     fps.state_dict().values()))
        if not same or fpipe.fps_embedder.fps_embed[0].weight.device.type != "cuda":
            _fail("vcbranches: the loaded FPS embedder differs from the source's or is not on "
                  "the card")
        print(f"vcbranches: FPS model written in {t_write:.2f} s (model.ckpt with "
              f"cond_stage2_model.*, model_config.yaml with cond_stage2_config), "
              f"load_vc_pipeline {t_load:.2f} s; the embedder's weights bit-identical to the "
              f"source's, on the card", flush=True)
        del fps, pipe
        _release()
        fargs = args.replace(model_type="VideoCrafter", model=VCB_FPS_NAME)
        launches["vcbranches_fps8"], fps8 = answer("FPS model, cond_fps 8", fpipe,
                                                   fargs.replace(cond_fps=8))
        launches["vcbranches_fps24"], fps24 = answer("FPS model, cond_fps 24", fpipe,
                                                     fargs.replace(cond_fps=24))
        _differ("vcbranches: cond_fps 8 against 24", fps8.frames, fps24.frames)
        try:
            fpipe.infer(fargs)
        except ValueError as e:
            print(f"vcbranches: no cond_fps on the FPS model raises: {e}", flush=True)
        else:
            _fail("vcbranches: the FPS model answered without cond_fps")
        del fps24

        # the depth adapter with MiDaS, at full size, from files
        t0 = time.perf_counter()
        adapter_path, midas_path, video = _write_depth_inputs(root)
        print(f"vcbranches: depth adapter files written in {time.perf_counter() - t0:.2f} s "
              f"({adapter_path.stat().st_size / 1e6:.1f} MB adapter, "
              f"{midas_path.stat().st_size / 1e6:.1f} MB MiDaS, 16-frame mp4)", flush=True)
        frames = np.stack(vid2frames(str(video), start_frame=0, end_frame=VC_T))
        t0 = time.perf_counter()
        stage = DepthStage.from_checkpoint(str(midas_path), fpipe.policy, device=fpipe.device)
        t_midas_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        depth = stage.video_depth(frames, (PX, PX))
        torch.cuda.synchronize()
        t_midas = time.perf_counter() - t0
        t0 = time.perf_counter()
        adapter = fpipe.load_adapter(str(adapter_path))
        t_adapter_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        feats = fpipe.adapter_features(adapter, depth[None])
        torch.cuda.synchronize()
        t_adapter = time.perf_counter() - t0
        shapes = [tuple(f.shape) for f in feats]
        want_shapes = [(1, VC_T, LAT >> i, LAT >> i, c)
                       for i, c in enumerate(AdapterConfig.depth_adapter().channels)]
        on_card = all(p.device.type == "cuda" for m in (adapter, stage.estimator)
                      for p in m.parameters())
        print(f"vcbranches: MiDaS {t_midas:.3f} s for {VC_T} frames (load {t_midas_load:.2f} s), "
              f"depth {tuple(depth.shape)} in [{depth.min().item():.2f}, "
              f"{depth.max().item():.2f}]; adapter {t_adapter:.3f} s (load "
              f"{t_adapter_load:.2f} s, {sum(p.numel() for p in adapter.parameters()) / 1e6:.1f}M "
              f"params), features {shapes}; both on the card: {on_card}", flush=True)
        if shapes != want_shapes or not on_card or not all(torch.isfinite(f).all() for f in feats):
            _fail(f"vcbranches: adapter features {shapes} (want {want_shapes}), on the card "
                  f"{on_card}")
        del stage, adapter, feats, depth
        _release()

        os.environ["T2V_MODELS_ROOT"] = str(root)
        aargs = fargs.replace(cond_fps=8)
        adapter_files = dict(adapter_ckpt=str(adapter_path), adapter_video=str(video),
                             depth_ckpt=str(midas_path))
        for label, call in (
                ("run", lambda: run_mod.run(aargs, T2VOutputArgs(), outdir=str(root / "a"),
                                            **adapter_files)),
                ("CLI", lambda: generate.main([
                    "--model-type", "VideoCrafter", "--model", VCB_FPS_NAME, "--prompt",
                    aargs.prompt, "--n-prompt", aargs.n_prompt, "--seed", str(aargs.seed),
                    "--steps", str(VC_STEPS), "--frames", str(VC_T), "--width", str(PX),
                    "--height", str(PX), "--cfg-scale", str(CFG), "--cond-fps", "8",
                    "--adapter-ckpt", str(adapter_path), "--adapter-video", str(video),
                    "--depth-ckpt", str(midas_path), "--outdir", str(root / "cli"),
                    "--json"]))):
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            t0 = time.perf_counter()
            with _no_plain_on_cuda(), _recording_infer(vc.VideoCrafterPipeline) as results:
                call()
            total = time.perf_counter() - t0
            launches[f"vcbranches_adapter_{label.lower()}"] = counts = _read_counters()
            if not _on(results, fpipe) or counts != expected:
                _fail(f"vcbranches: the depth adapter through {label}: {len(results)} requests "
                      f"(on the loaded FPS pipeline: {_on(results, fpipe)}), launches {counts}, "
                      f"expected {expected}")
            tm = results[0].timings
            print(f"vcbranches: depth adapter through {label} {total:.3f} s (files, MiDaS, "
                  f"adapter, request and outputs; its request {sum(tm.values()):.3f} s), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {counts}",
                  flush=True)
            _differ(f"vcbranches: the depth adapter through {label} against the request "
                    "without it", results[0].frames, fps8.frames)
            if label == "run":
                adapted = results[0].frames
            else:
                _same_frames("vcbranches: the depth adapter through the CLI", results[0].frames,
                             adapted)
            del results
        del fpipe
    finally:
        if saved_root is None:
            os.environ.pop("T2V_MODELS_ROOT", None)
        else:
            os.environ["T2V_MODELS_ROOT"] = saved_root
        run_mod._warm_pipe = None
        pl._PIPELINE_CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)
        _release()
    return launches


def drive_vcddpm() -> dict:
    """The full-width DDPM request (``--only vcddpm``; left out of the
    default run for its time): the whole 1,000-step ancestral chain with
    CFG 9 on the pipeline of ``drive_vcbranches``, launches against the
    topology's for 1,000 UNet calls."""
    import torch

    from t2v_torch.core.config import CLIPTextConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
    from t2v_torch.text.tokenizer import CLIPTokenizer

    pipe = VideoCrafterPipeline.random_init(policy=Policy.bf16(), seed=0, device="cuda",
                                            clip_cfg=CLIPTextConfig.clip_l_14())
    _perturb_zero_leaves(pipe)
    pipe.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
    steps = pipe.schedule.num_timesteps
    expected = _expected(count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT), steps, 1)
    counts, res = _answer(f"vcddpm: full-width DDPM ({steps} steps)", pipe, T2VArgs(**VCB_ARGS),
                          VC_T, expected, steps, sample_type="ddpm")
    print(f"vcddpm: {sum(res.timings.values()):.1f} s for the request on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    del pipe, res
    _release()
    return {"vcddpm": counts}


def _capture_unet_path(pipe, recs: dict) -> dict:
    """The path of rows 9 and 10: one CFG-batched 24-frame UNet call of the
    full-width pipeline with forward hooks that keep the q/k/v of every
    temporal self-attention (unswapped to the sample-major (B*F, N, H*D)
    layout) and the projection of every GEGLU site; then
    ``temporal_attention_packed`` and ``geglu`` on each capture. Counts are
    reset just before the call and read just after the last entry; each
    result is then held against the model's own route on the same tensors
    (``self_attention_packed`` on the token layout; ``GEGLU.forward``'s
    output) and against the plain version. Returns the launches."""
    import torch

    from t2v_torch.kernels import fused_mha
    from t2v_torch.kernels.attention import self_attention_packed, temporal_attention_packed
    from t2v_torch.kernels.geglu import geglu, geglu_plain
    from t2v_torch.models.modelscope_unet import count_kernel_sites

    unet = pipe.unet
    topo = unet.topology
    descs = [d for entry in (*topo.encoder, topo.middle, *topo.decoder) for d in entry]
    # every temporal transformer runs two self-attentions; every spatial and
    # temporal transformer block has one GEGLU feed-forward
    want_temporal = 2 * sum(d.kind == "temporal" for d in descs)
    want_geglu = sum(d.kind in ("spatial", "temporal") for d in descs)
    caps_t, caps_g, hooks = [], [], []

    def keep(rec, name):
        return lambda mod, args, out: rec.__setitem__(name, out)

    for d in descs:
        if d.kind not in ("spatial", "temporal"):
            continue
        block = unet.get_submodule(d.torch_path).transformer_blocks[0]
        if d.kind == "temporal":
            for attn in (block.attn1, block.attn2):
                rec = {"heads": attn.heads, "site": d.torch_path}
                caps_t.append(rec)
                hooks += [getattr(attn, n).register_forward_hook(keep(rec, n))
                          for n in ("to_q", "to_k", "to_v")]
        ff = block.ff.net[0]
        rec = {"site": d.torch_path}
        caps_g.append(rec)
        hooks += [ff.proj.register_forward_hook(keep(rec, "proj")),
                  ff.register_forward_hook(keep(rec, "model"))]

    dev = pipe.device
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, T, LAT, LAT, 4), generator=g, device=dev)
    t = torch.full((2,), 981.0, device=dev)
    ctx = torch.randn((2, 77, pipe.unet_cfg.context_dim), generator=g, device=dev)
    _reset_counters()
    with torch.no_grad(), _no_plain_on_cuda():
        unet(x, t, ctx)
        for h in hooks:
            h.remove()
        for rec in caps_t:
            rec["n"] = rec["to_q"].shape[0] // x.shape[0]
            rec["qkv"] = [fused_mha.unswap_frame_axis(rec[k], rec["n"])
                          for k in ("to_q", "to_k", "to_v")]
            rec["got"] = temporal_attention_packed(*rec["qkv"], rec["heads"], T)
        for rec in caps_g:
            rec["got"] = geglu(rec["proj"])
    torch.cuda.synchronize()
    counts = _read_counters()
    expected = _expected(count_kernel_sites(pipe.unet_cfg, T, LAT, LAT), 1, 0)
    expected.update(fused_temporal_mha=want_temporal, geglu=want_geglu)
    print(f"row 9/10 path: one UNet call (2 x {T} frames, {LAT}x{LAT} latent), "
          f"{len(caps_t)} temporal self-attention and {len(caps_g)} GEGLU captures, "
          f"launches {counts}", flush=True)
    if (len(caps_t), len(caps_g)) != (want_temporal, want_geglu) or counts != expected:
        _fail(f"row 9/10 path: {len(caps_t)} / {len(caps_g)} captures and launches {counts}, "
              f"expected {want_temporal} / {want_geglu} and {expected}")

    with torch.no_grad():
        for rec in caps_t:
            q, k, v = (rec[n] for n in ("to_q", "to_k", "to_v"))
            model = fused_mha.unswap_frame_axis(self_attention_packed(q, k, v, rec["heads"]),
                                                rec["n"])
            label = f"{rec['site']} x{tuple(rec['got'].shape)} heads={rec['heads']}"
            _compare(recs["fused_temporal_mha"], f"vs model {label}", rec["got"], model)
            _compare(recs["fused_temporal_mha"], f"vs plain {label}", rec["got"],
                     fused_mha.fused_temporal_mha_plain(*rec["qkv"], rec["heads"], T))
        for rec in caps_g:
            label = f"{rec['site']} proj{tuple(rec['proj'].shape)}"
            # the model rounds gelu(gate) to bf16 before the product: each
            # value may land one more bf16 step away
            _compare_steps(recs["geglu"], f"vs model {label}", rec["got"], rec["model"], 2)
            _compare_steps(recs["geglu"], f"vs plain {label}", rec["got"],
                           geglu_plain(rec["proj"]), 1)
    torch.cuda.synchronize()
    del caps_t, caps_g
    _release()
    return counts


def _unet_calls(pipe, sampler: str, steps: int, vid2vid_strength=None) -> int:
    """UNet calls of a request: a multistep sampler calls the model once per
    step; DDIM vid2vid runs int(strength * steps) rungs; the others their
    plan's steps."""
    from t2v_torch.diffusion import ddim
    from t2v_torch.diffusion.sampling import get_sampler

    mod = get_sampler(sampler)
    if getattr(mod, "MULTISTEP", False):
        return steps
    if vid2vid_strength is not None and mod is ddim:
        return int(vid2vid_strength * steps)
    return mod.plan(pipe.schedule, steps).steps


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)


def drive_modes(recs: dict) -> dict:
    """The ModelScope request modes on the full-width pipeline of phase 4
    (24 frames at 256x256, CFG 9): UniPC, DPM++ 2M Karras and Euler a (20
    steps each); vid2vid with DDIM_Gaussian (strength 0.75) and DDIM
    (strength 0.5) on the UniPC request's frames through compute_latents;
    img2vid progressive inpainting (DDIM_Gaussian) from its frame 0 with 12
    inpainting frames; an exact DDIM_Gaussian request and the same request
    with DeepCache interval 2 (PSNR printed, no limit: the weights are
    random); the same request windowed by a callback every 5 steps, which
    must reproduce the exact latents bit for bit; and one whose callback
    interrupts it after the second window. Each request's launches must
    equal the topology's sites times its UNet calls (DeepCache: full calls
    times the full sites plus cached calls times the shallow sites). First,
    the path of rows 9 and 10 on the captured activations of one UNet call.
    Returns the launches per path."""
    import numpy as np
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.core.state import InterruptedException
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    t0 = time.perf_counter()
    pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0,
                                          device="cuda")
    _perturb_zero_leaves(pipe)
    torch.cuda.synchronize()
    print(f"modes: ModelScope pipeline random_init {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"modelscope_unet_capture": _capture_unet_path(pipe, recs)}

    full = count_kernel_sites(pipe.unet_cfg, T, LAT, LAT)
    shallow = count_kernel_sites(pipe.unet_cfg, T, LAT, LAT, cached=True)

    def expect(calls, cached_calls=0, decodes=1):
        out = _expected(full, calls, decodes)
        for k, v in shallow.items():
            out[k] += cached_calls * v
        return out

    def request(label, args, calls, cached_calls=0, decodes=1, **kw):
        counts, res = _answer(f"modes {label}", pipe, args, T, expect(calls, cached_calls,
                                                                       decodes),
                              calls + cached_calls, **kw)
        launches[f"modes_{label}"] = counts
        return res

    base = dict(prompt="a red fox running through the snow, masterpiece", frames=T, width=PX,
                height=PX, cfg_scale=CFG, steps=STEPS)
    first = None
    for i, sampler in enumerate(("UniPC", "DPM++ 2M Karras", "Euler a")):
        res = request(sampler.replace(" ", "_"), T2VArgs(**base, sampler=sampler, seed=40 + i),
                      _unet_calls(pipe, sampler, STEPS))
        first = first if first is not None else res

    source = first.frames.astype(np.float32) / 255.0 * 2.0 - 1.0
    latents = pipe.compute_latents(source)
    for sampler, strength in (("DDIM_Gaussian", 0.75), ("DDIM", 0.5)):
        skip = int(math.floor(STEPS * (1.0 - strength)))
        request(f"vid2vid_{sampler}", T2VArgs(**base, sampler=sampler, strength=strength, seed=50),
                _unet_calls(pipe, sampler, STEPS - skip, strength), latents=latents,
                is_vid2vid=True, skip_steps=skip)

    args = T2VArgs(**base, seed=60, inpainting_frames=T // 2)
    masked, mask, image_latents = pipe.build_inpainting_inputs(first.frames[0], args)
    request("inpaint_progressive", args, _unet_calls(pipe, "DDIM_Gaussian", STEPS),
            latents=masked, mask=mask, image_latents=image_latents, inpaint_mode="progressive")

    exact_args = T2VArgs(**base, seed=70)
    n = _unet_calls(pipe, "DDIM_Gaussian", STEPS)
    exact = request("exact", exact_args, n)
    cache = request("deepcache_2", exact_args, (n + 1) // 2, n // 2, deep_cache_interval=2)
    print(f"modes DeepCache interval 2: frames {_psnr(cache.frames, exact.frames):.2f} dB PSNR "
          f"from the exact request (random weights: reported, no limit)", flush=True)
    seen = []
    windowed = request("windowed", exact_args, n, callback=seen.append, callback_interval=5)
    same = torch.equal(windowed.latents, exact.latents)
    print(f"modes windowed: callbacks at {seen}, latents equal to the un-windowed request's bit "
          f"for bit: {same}", flush=True)
    if not same or seen != list(range(5, n + 1, 5)):
        _fail(f"modes windowed: callbacks {seen}, latents equal {same}")

    stops = []

    def interrupt(done):
        stops.append(done)
        if len(stops) == 2:
            raise InterruptedException

    _reset_counters()
    try:
        with _no_plain_on_cuda():
            pipe.infer(exact_args, callback=interrupt, callback_interval=5)
    except InterruptedException:
        counts = _read_counters()
        print(f"modes interrupted: stopped after the callback at step {stops[-1]}, launches "
              f"{counts}", flush=True)
        if stops != [5, 10] or counts != expect(10, decodes=0):
            _fail(f"modes interrupted: callbacks {stops}, launches {counts}")
        launches["modes_interrupted"] = counts
    else:
        _fail("modes interrupted: the callback's InterruptedException did not stop the request")
    del pipe
    _release()
    return launches


def drive_videocrafter(serve: bool = True, train: bool = True) -> dict:
    """One full-width VideoCrafter pipeline. ``serve``: two requests and one
    UNet-call profile. ``train``: a full fine-tune (2 steps). Returns the
    kernels' launches per path."""
    import torch

    from t2v_torch.core.config import T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    t0 = time.perf_counter()
    pipe = VideoCrafterPipeline.random_init(policy=Policy.bf16(), seed=0, device="cuda")
    _perturb_zero_leaves(pipe)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"VideoCrafter pipeline: random_init {time.perf_counter() - t0:.1f} s, UNet "
          f"{n_unet / 1e9:.3f}B params, CLIP-L {pipe.clip_cfg.layers} layers, bf16 on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    launches = {}
    if serve:
        launches["videocrafter_16f"] = _serve_videocrafter(pipe)
    if train:
        launches["videocrafter_full_train"] = _train_run(
            "VideoCrafter full fine-tune", pipe,
            count_vc_kernel_sites(pipe.cfg, TRAIN_T, LAT, LAT), lora_rank=0, ema_decay=None,
            steps=2, seed=23)
    del pipe
    _release()
    return launches


def _serve_videocrafter(pipe) -> dict:
    import torch

    from t2v_torch.core.config import T2VArgs
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites

    expected = _expected(count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT), VC_STEPS, 1)
    requests = [
        T2VArgs(prompt="a photo of a cat in the forest", n_prompt="blurry", seed=1234,
                steps=VC_STEPS, frames=VC_T, width=256, height=256, cfg_scale=CFG),
        T2VArgs(prompt="a bunny in a forest, masterpiece", seed=77, steps=VC_STEPS,
                frames=VC_T, width=256, height=256, cfg_scale=CFG),
    ]
    launches = None
    for i, args in enumerate(requests):
        launches = _answer(f"VideoCrafter 16f request {i}", pipe, args, VC_T, expected,
                           VC_STEPS)[0]

    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    ctx = torch.randn((2, 77, pipe.cfg.context_dim), generator=g, device="cuda")
    profile_unet("VideoCrafter", pipe.unet, VC_T, ctx, g)
    return launches


def _grad_check(label, fn, plain, inputs, g) -> None:
    """The gradients an autograd.Function returns on the card against
    autograd through the plain version on the same bf16 inputs."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    grad_out = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    got = torch.autograd.grad(out, leaves, grad_out)
    ref_leaves = [t.detach().requires_grad_() for t in inputs]
    want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, grad_out)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a.float() - b.float()).abs().max().item()
        scale = max(b.float().abs().max().item(), 1e-6)
        worst = max(worst, err / scale)
        if not torch.isfinite(a).all() or err > TOL_SHARE * scale:
            _fail(f"gradient check {label}: input {i} max abs error {err} above "
                  f"{TOL_SHARE * scale}")
    print(f"  gradient {label:44s} {len(got)} inputs, worst error {worst:.3e} of max |grad| "
          f"(limit {TOL_SHARE}) ok", flush=True)


def check_gradients() -> None:
    """Each of the seven autograd.Functions at one training-path shape."""
    import torch

    from t2v_torch.kernels import flash_attention as fa
    from t2v_torch.kernels import fused_mha as fm
    from t2v_torch.kernels import geglu as gg
    from t2v_torch.kernels import relpos_mha as rp
    from t2v_torch.kernels import temporal_conv as tc

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    bf = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    before = _read_counters()
    _grad_check("flash (80, 1024, 1024, 64)",
                lambda q, k, v: fa.FlashAttentionFunction.apply(q, k, v, 0.125),
                lambda q, k, v: fa.flash_attention_plain(q, k, v, 0.125),
                [bf(80 * TRAIN_B, 1024, 64) for _ in range(3)], g)
    _grad_check("fused_self_mha (16, 256, 640) 10 h",
                lambda q, k, v: fm.FusedSelfMHAFunction.apply(q, k, v, 10, 0.125),
                lambda q, k, v: fm.fused_self_mha_plain(q, k, v, 10, 0.125),
                [bf(16 * TRAIN_B, 256, 640) for _ in range(3)], g)
    _grad_check("fused_cross_mha (1, 16384, 320) x 77, 8 h",
                lambda q, k, v: fm.FusedCrossMHAFunction.apply(q, k, v, 8, 40 ** -0.5),
                lambda q, k, v: fm.fused_cross_mha_plain(q, k, v, 8, 40 ** -0.5),
                [bf(TRAIN_B, 16384, 320), bf(TRAIN_B, 77, 320), bf(TRAIN_B, 77, 320)], g)
    _grad_check("relpos_mha (16, 1024, 320) 8 h, T = 16",
                lambda *a: rp.RelposMHAFunction.apply(*a, 8, 16, 40 ** -0.5),
                lambda *a: rp.relpos_mha_plain(*a, 8, 16, 40 ** -0.5),
                [*(bf(16 * TRAIN_B, 1024, 320) for _ in range(3)), bf(16, 16, 40),
                 bf(16, 16, 40)], g)
    layers = _chain_layers(g, 320)
    flat = [t for layer in layers for t in layer]
    regroup = lambda ts: [ts[i:i + 4] for i in range(0, 16, 4)]
    _grad_check("temporal_conv_chain (1, 16, 1024, 320)",
                lambda x, *ts: tc.TemporalConvChainFunction.apply(1e-5, x, *ts),
                lambda x, *ts: tc.chain_plain(x, regroup(ts)),
                [bf(TRAIN_B, TRAIN_T, 1024, 320), *flat], g)
    _grad_check("fused_temporal_mha (16, 1024, 320) 5 h, F = 16",
                lambda q, k, v: fm.FusedTemporalMHAFunction.apply(q, k, v, 5, TRAIN_T, 0.125),
                lambda q, k, v: fm.fused_temporal_mha_plain(q, k, v, 5, TRAIN_T, 0.125),
                [bf(TRAIN_T * TRAIN_B, 1024, 320) for _ in range(3)], g)
    _grad_check("geglu (16384, 2560)", gg.GEGLUFunction.apply, gg.geglu_plain,
                [bf(TRAIN_T * TRAIN_B * 1024, 2560)], g)
    after = _read_counters()
    moved = {k: after[k] - before[k] for k in after}
    want = {"temporal_conv": 4, "flash_attention": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
            "fused_self_mha": 1, "fused_cross_mha": 1, "relpos_mha": 1,
            "fused_temporal_mha": 1, "geglu": 1}
    if moved != want:
        _fail(f"gradient checks launched {moved}, expected {want}")
    _release()


def check_mesh_gradients() -> None:
    """The attention Functions at the tp- and sp-local shapes of the mesh
    training paths (``meshtrain``): a split attention runs on heads / 2,
    split frames on 8 of the 16. The temporal conv chain and the sp rel-pos
    sites run gathered, at the serial shapes of ``check_gradients``."""
    import torch

    from t2v_torch.kernels import flash_attention as fa
    from t2v_torch.kernels import fused_mha as fm
    from t2v_torch.kernels import relpos_mha as rp

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    bf = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    before = _read_counters()
    flash = lambda scale: (lambda q, k, v: fa.FlashAttentionFunction.apply(q, k, v, scale))
    flash_plain = lambda scale: (lambda q, k, v: fa.flash_attention_plain(q, k, v, scale))
    _grad_check("flash (40, 1024, 1024, 64): ModelScope sp", flash(0.125), flash_plain(0.125),
                [bf(40 * TRAIN_B, 1024, 64) for _ in range(3)], g)
    _grad_check("flash (64, 1024, 1024, 40): VideoCrafter tp, sp", flash(40 ** -0.5),
                flash_plain(40 ** -0.5), [bf(64 * TRAIN_B, 1024, 40) for _ in range(3)], g)
    for rows, width, heads, where in ((16, 320, 5, "tp"), (8, 640, 10, "sp")):
        _grad_check(f"fused_self_mha ({rows}, 256, {width}) {heads} h: ModelScope {where}",
                    lambda q, k, v, h=heads: fm.FusedSelfMHAFunction.apply(q, k, v, h, 0.125),
                    lambda q, k, v, h=heads: fm.fused_self_mha_plain(q, k, v, h, 0.125),
                    [bf(rows * TRAIN_B, 256, width) for _ in range(3)], g)
    for n, width, heads, where in ((16384, 160, 4, "tp"), (8192, 320, 8, "sp")):
        _grad_check(f"fused_cross_mha (1, {n}, {width}) x 77, {heads} h: VideoCrafter {where}",
                    lambda q, k, v, h=heads: fm.FusedCrossMHAFunction.apply(q, k, v, h,
                                                                            40 ** -0.5),
                    lambda q, k, v, h=heads: fm.fused_cross_mha_plain(q, k, v, h, 40 ** -0.5),
                    [bf(TRAIN_B, n, width), bf(TRAIN_B, 77, width), bf(TRAIN_B, 77, width)], g)
    _grad_check("relpos_mha (16, 1024, 160) 4 h, T = 16: VideoCrafter tp",
                lambda *a: rp.RelposMHAFunction.apply(*a, 4, 16, 40 ** -0.5),
                lambda *a: rp.relpos_mha_plain(*a, 4, 16, 40 ** -0.5),
                [*(bf(16 * TRAIN_B, 1024, 160) for _ in range(3)), bf(16, 16, 40),
                 bf(16, 16, 40)], g)
    after = _read_counters()
    moved = {k: after[k] - before[k] for k in after}
    want = {k: 0 for k in after}
    want.update(flash_attention=2, flash_bwd_dkv=2, flash_bwd_dq=2, fused_self_mha=2,
                fused_cross_mha=2, relpos_mha=1)
    if moved != want:
        _fail(f"mesh-shape gradient checks launched {moved}, expected {want}")
    _release()


def _lora_loss_and_grads(pipe, lora_np, batch_np, draw_np, device):
    """One LoRA loss and its gradients on ``pipe`` from numpy inputs."""
    import numpy as np
    import torch

    from t2v_torch.parallel import train as T
    from t2v_torch.pipeline import lora as L

    dev = torch.device(device)
    index = L.unet_module_index(pipe.unet_cfg)
    lora = {name: {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in ab.items()}
            for name, ab in lora_np.items()}
    base = {k: v.detach() for k, v in pipe.unet.named_parameters()}
    batch = {k: torch.tensor(v, device=dev) for k, v in batch_np.items()}
    draw = (torch.tensor(draw_np[0], device=dev), torch.tensor(draw_np[1], device=dev))
    loss = T.diffusion_loss(T.module_apply_fn(pipe.unet), L.apply_lora(base, lora, index),
                            T.schedule_tables(pipe.schedule, dev), batch, None, "eps", draw)
    leaves = T.tree_leaves(lora)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), np.concatenate([g.float().cpu().numpy().ravel() for g in grads])


def check_small_training(device: str = "cuda") -> dict:
    """One LoRA training step's loss and gradients on the small ModelScope
    UNet: bf16 on ``device`` (the kernels, forward and backward) against
    float32 on the CPU, with the limit taken from a bf16 CPU run (the plain
    versions) of the same weights, inputs, timestep and noise."""
    import numpy as np
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.pipeline import lora as L
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    cfg = ModelScopeUNetConfig(**SMALL_UNET)
    build = lambda policy, dev: ModelScopePipeline.random_init(cfg, policy, seed=0, device=dev)
    ref = build(Policy.fp32(), "cpu")
    _perturb_zero_leaves(ref)
    rng = np.random.default_rng(11)
    index = L.unet_module_index(cfg)
    gen = torch.Generator().manual_seed(11)
    lora0 = L.init_lora(dict(ref.unet.named_parameters()), index, 4, gen)
    # B starts at zero, which would zero every gradient of A: give it signal
    lora_np = {name: {"lora_A": ab["lora_A"].detach().numpy(),
                      "lora_B": (0.02 * rng.standard_normal(ab["lora_B"].shape)).astype(np.float32)}
               for name, ab in lora0.items()}
    batch_np = {"latents": rng.standard_normal((1, 8, 32, 32, 4)).astype(np.float32),
                "context": rng.standard_normal((1, 77, cfg.context_dim)).astype(np.float32)}
    draw_np = (np.array([481]), rng.standard_normal((1, 8, 32, 32, 4)).astype(np.float32))

    def copy(policy, dev):
        pipe = build(policy, dev)
        for dst, src in zip(_models(pipe), _models(ref)):
            dst.load_state_dict(src.state_dict())
        return pipe

    want_loss, want_g = _lora_loss_and_grads(ref, lora_np, batch_np, draw_np, "cpu")
    cpu_loss, cpu_g = _lora_loss_and_grads(copy(Policy.bf16(), "cpu"), lora_np, batch_np,
                                           draw_np, "cpu")
    pipe = copy(Policy.bf16(), device)
    _reset_counters()
    with _no_plain_on_cuda():
        got_loss, got_g = _lora_loss_and_grads(pipe, lora_np, batch_np, draw_np, device)
    launches = _read_counters()

    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    # a scalar's bf16 distance can be near zero by chance, so the loss's
    # limit is never below one bf16 ulp (2^-8) of the reference
    checks = (("loss", abs(got_loss - want_loss) / abs(want_loss),
               max(abs(cpu_loss - want_loss) / abs(want_loss), 2.0 ** -8)),
              ("LoRA gradients", rel(got_g, want_g), rel(cpu_g, want_g)),
              ("largest LoRA gradient", abs(np.abs(got_g).max() - np.abs(want_g).max())
               / np.abs(want_g).max(),
               max(abs(np.abs(cpu_g).max() - np.abs(want_g).max()) / np.abs(want_g).max(),
                   2.0 ** -8)))
    for what, err, floor in checks:
        ok = err <= SMALL_RATIO * floor
        print(f"small training step {what}: bf16 on {device} {err:.3e} from the float32 "
              f"reference, bf16 on cpu {floor:.3e}, limit {SMALL_RATIO * floor:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            _fail(f"small training step {what}: {err} from the reference, above "
                  f"{SMALL_RATIO} x {floor}")
    print(f"small training step: loss {got_loss:.5f} (float32 {want_loss:.5f}), "
          f"{got_g.size} gradient values, launches on {device}: {launches}", flush=True)
    return launches


def _synthetic_clips(seed: int, n: int):
    """(n, TRAIN_T, 256, 256, 3) float32 clips in [-1, 1] from a seed:
    coarse random blocks over a drifting ramp."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blocks = rng.uniform(-1.0, 1.0, (n, TRAIN_T, 8, 8, 3)).astype(np.float32)
    blocks = blocks.repeat(32, axis=2).repeat(32, axis=3)
    ramp = np.linspace(-1.0, 1.0, 256, dtype=np.float32)[None, None, None, :, None]
    drift = np.linspace(0.0, 0.5, TRAIN_T, dtype=np.float32)[None, :, None, None, None]
    return np.clip(0.6 * blocks + 0.4 * (ramp + drift), -1.0, 1.0)


_CAPTIONS = ("a photo of a cat in the forest", "a bunny on a snowy hill, masterpiece")


def _fingerprint(params) -> "torch.Tensor":
    import torch

    return torch.stack([p.detach().float().sum() for p in params])


def _train_run(label, pipe, per_call: dict, *, lora_rank: int, ema_decay, steps: int,
               seed: int) -> dict:
    """A few full-width training steps through the entry points a trainer
    calls: clips -> compute_latents, captions -> the text tower, the train
    step. Checks every loss, that the trained leaves moved (and, for LoRA,
    that the frozen base did not), the EMA rule on one leaf, and the launch
    counts; prints seconds per step (second step on), the peak memory and
    the idle share of one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from t2v_torch.parallel import train as T
    from t2v_torch.pipeline import lora as L

    is_vc = not hasattr(pipe, "text_encoder")
    unet_cfg = pipe.cfg if is_vc else pipe.unet_cfg
    dev = pipe.device
    base = dict(pipe.unet.named_parameters())
    opt = T.make_optimizer(1e-4, 1e-2)
    apply_fn = T.module_apply_fn(pipe.unet)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    before_base = _fingerprint(base.values())
    if lora_rank:
        index = L.unet_module_index(unet_cfg)
        state = T.init_train_state(L.init_lora(base, index, lora_rank, gen), opt)
        step_fn = T.make_lora_train_step(apply_fn, pipe.schedule, base, index,
                                         parameterization=unet_cfg.parameterization)
    else:
        state = T.init_train_state(base, opt, with_ema=ema_decay is not None)
        step_fn = T.make_train_step(apply_fn, pipe.schedule, ema_decay=ema_decay,
                                    parameterization=unet_cfg.parameterization)
    before = _fingerprint(T.tree_leaves(state.params))
    ema_name = next(iter(state.ema_params)) if state.ema_params is not None else None

    clips = _synthetic_clips(seed, TRAIN_B)
    captions = [_CAPTIONS[i % len(_CAPTIONS)] for i in range(TRAIN_B)]
    _reset_counters()
    losses, times = [], []
    with _no_plain_on_cuda():
        latents = torch.cat([pipe.compute_latents(c) for c in clips], dim=0)
        if is_vc:
            context = pipe.encode_text(captions)
        else:
            context = torch.stack([pipe.text_encoder.encode_line(c) for c in captions])
        batch = {"latents": latents, "context": context}
        if not torch.isfinite(latents).all() or latents.std() == 0:
            _fail(f"{label}: the encoded latents are not finite or carry no signal")
        for _ in range(steps):
            if ema_name is not None:
                ema_old = state.ema_params[ema_name].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if ema_name is not None:
                want = ema_old * ema_decay + state.params[ema_name].detach().float() * (1.0 - ema_decay)
                if not torch.allclose(state.ema_params[ema_name], want, rtol=1e-5, atol=1e-7):
                    _fail(f"{label}: EMA of {ema_name} is not decay * old + (1 - decay) * new")
        counts = _read_counters()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # one more step under the profiler: the device's busy time in a step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, loss = step_fn(state, batch, gen)
            torch.cuda.synchronize()
        losses.append(float(loss))
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels) / 1e3
    n_kernels = sum(k[1] for k in kernels)

    enc_chunks = TRAIN_B * -(-TRAIN_T // 8)
    expected = {k: 0 for k in _counters()}
    expected.update({k: steps * v for k, v in per_call.items()})
    flash_sites = per_call["flash_attention"]
    expected["flash_attention"] += enc_chunks  # the VAE encoder's mid-block attention
    expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = steps * flash_sites
    steady = sum(times[1:]) / max(1, len(times) - 1)
    idle = f"{100 * (1 - busy / steady):.0f}%" if busy else "not measured"
    print(f"{label}: batch {TRAIN_B} x {TRAIN_T} frames, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; first step {times[0]:.3f} s, then "
          f"{steady:.3f} s/step; peak {peak:.2f} GiB; one profiled step: {busy:.3f} s of "
          f"device time in {n_kernels} kernels, idle {idle} of a step; launches {counts}",
          flush=True)
    if busy:
        _print_breakdown(kernels, 1e3 * busy, top=4)
    if not all(math.isfinite(x) for x in losses):
        _fail(f"{label}: a loss is not finite: {losses}")
    after = _fingerprint(T.tree_leaves(state.params))
    if not torch.isfinite(after).all() or torch.equal(before, after):
        _fail(f"{label}: the trained parameters did not change, or are not finite")
    if not torch.equal(before_base, _fingerprint(base.values())):
        _fail(f"{label}: the pipeline's own weights (the frozen base of a LoRA run) changed")
    if counts != expected:
        _fail(f"{label}: launch counts {counts} differ from the topology's {expected}")
    del state, step_fn, batch
    _release()
    return counts


_CATEGORIES = (
    ("temporal_conv kernels", ("temporal_conv_gemm_kernel", "temporal_conv_act_kernel",
                               "temporal_conv_stats_kernel")),
    ("flash_attention kernel", ("flash_fwd_kernel",)),
    ("flash backward kernels", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("fused_self_mha / fused_cross_mha kernel", ("packed_mha_kernel",)),
    ("relpos_mha kernel", ("relpos_mha_kernel",)),
    ("geglu kernel", ("geglu_kernel",)),
    ("convolution (cuDNN)", ("conv", "fprop", "implicit", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet")),
)


def profile_unet(label, unet, frames, ctx, g) -> None:
    """Where one UNet call's device time goes: a CFG-batched call on the
    request's latent, timed with CUDA events, then once under
    torch.profiler with its kernels' device time summed by category."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((2, frames, LAT, LAT, 4), generator=g, device="cuda")
    t = torch.full((2,), 981.0, device="cuda")
    with torch.no_grad():
        ms = _time_ms(lambda: unet(x, t, ctx), 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            unet(x, t, ctx)
            torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    n_launch = sum(k[1] for k in kernels)
    print(f"profile {label}: one UNet call (2 x {frames} frames, {LAT}x{LAT} latent) {ms:.2f} "
          f"ms by CUDA events; {n_launch} profiled kernels, {busy:.2f} ms of device time",
          flush=True)
    if busy == 0:
        print(f"profile {label}: the profiler recorded no device time (breakdown not measured)")
        return
    _print_breakdown(kernels, busy)


def _device_kernels(prof) -> list:
    """(device ms, count, name) of every kernel a profile recorded. Ranges
    that annotate a span of kernels (``Optimizer.step#AdamW.step``) carry
    their kernels' time a second time and are left out."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def _print_breakdown(kernels, busy: float, top: int = 10) -> None:
    """(device ms, count, name) kernel rows summed by category."""
    sums: dict[str, list] = {}
    for dev_ms, count, name in kernels:
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES if any(k in low for k in keys)),
                   "elementwise, norms, copies")
        entry = sums.setdefault(cat, [0.0, 0])
        entry[0] += dev_ms
        entry[1] += count
    for cat, (dev_ms, count) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat:28s} {dev_ms:8.2f} ms  {100 * dev_ms / busy:5.1f}%  x{count}")
    for dev_ms, count, name in sorted(kernels, reverse=True)[:top]:
        print(f"  top {dev_ms:8.2f} ms x{count:<4d} {name[:110]}")


# ---------------------------------------------------------------------------
# Sharded sampling (``--only parallel``): the one-process batched path, two
# ranks sharing the card over gloo (dp, tp and sp), and the CLI under torchrun

PAR_RANKS = 2
PAR_STEPS = 4              # steps of the tp and sp requests
PAR_CALLS = (0, 2, 3)      # their UNet calls held against the one-rank call
PAR_TIMEOUT = 600          # seconds the two ranks, and then the CLI call, may take
PAR_FAMILIES = ("modelscope", "videocrafter")


def _par_pipeline(family: str):
    """The full-width bf16 pipeline of ``family`` from seed 0, its zero
    leaves perturbed; ModelScope's with the published 49,408-row text
    embedding and the repo's vocab, so that a directory saved from it loads
    the same pipeline."""
    from t2v_torch.core.config import CLIPTextConfig, ModelScopeUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.pipeline.pipeline import ModelScopePipeline
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
    from t2v_torch.text.tokenizer import CLIPTokenizer

    if family == "modelscope":
        pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0,
                                              device="cuda", clip_cfg=CLIPTextConfig.vit_h_14())
        pipe.text_encoder.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
    else:
        pipe = VideoCrafterPipeline.random_init(policy=Policy.bf16(), seed=0, device="cuda")
    _perturb_zero_leaves(pipe)
    return pipe


def _par_request(family: str, steps: int, batch_count: int = 1):
    from t2v_torch.core.config import T2VArgs

    return T2VArgs(prompt="a photo of a cat in the forest", n_prompt="blurry", seed=1234,
                   steps=steps, frames=T if family == "modelscope" else VC_T, width=PX,
                   height=PX, cfg_scale=CFG, batch_count=batch_count)


def _par_per_call(pipe, family: str) -> dict:
    """One UNet call's launches. The sharded paths launch as many: a split
    attention runs its kernels on the local heads, one launch a site;
    frames split over sp are gathered before the temporal conv chain and
    the temporal attention, and the spatial sites run on the local frames."""
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites

    if family == "modelscope":
        return count_kernel_sites(pipe.unet_cfg, T, LAT, LAT)
    return count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT)


def _audit_lines(tag: str, inv) -> dict:
    """Prints one line per mesh axis and kind of the inventory ``inv``
    (calls and bytes, and their split by phase); returns {"axis kind":
    [calls, bytes]}."""
    rows: dict = {}
    for (axis, kind, phase), (calls, nbytes) in sorted(inv.tally().items()):
        row = rows.setdefault(f"{axis} {kind}", [0, 0, []])
        row[0] += calls
        row[1] += nbytes
        row[2].append(f"{phase} {calls} / {nbytes:,} B")
    for key, (calls, nbytes, phases) in rows.items():
        print(f"{tag}: audit {key}: {calls} calls, {nbytes:,} B ({'; '.join(phases)})",
              flush=True)
    if not rows:
        print(f"{tag}: audit: no collectives", flush=True)
    return {key: row[:2] for key, row in rows.items()}


def _audit_faults(label, inv, census, unet, tp: int, sp: int, calls: int, frames: int) -> list:
    """What of the forward and backward collectives of ``inv`` (``calls``
    UNet calls at tp x sp) does not follow the port's model: each site that
    the tp and sp hooks installed called once a call, the collectives
    exactly those the sites give (``audit.site_census``), every sp gather
    carrying all ``frames``, and no all-gather of a full parameter outside
    the save phase."""
    from t2v_torch.parallel import audit

    faults = []
    sites = audit.installed_sites(unet, tp, sp)
    called = {k: v for k, v in census.site_calls.items() if k != "column-parallel"}
    if called != {k: calls * n for k, n in sites.items()}:
        faults.append(f"{label}: sites called {called}, the model's {dict(sites)} x {calls}")
    got = inv.select(phases=("forward", "backward")).tally()
    if got != census.expected:
        faults.append(f"{label}: collectives {got}, the sites give {census.expected}")
    short = [op.shapes for op in inv.select(axis="sp", kind="all-gather").ops
             if any(dims[1] != frames for dims in op.shapes)]
    if short:
        faults.append(f"{label}: sp gathers without all {frames} frames: {short[:3]}")
    try:
        audit.assert_no_param_gather(inv, audit.param_full_shapes(unet))
    except AssertionError as e:
        faults.append(f"{label}: {e}")
    return faults


def _par_audit(label, pipe, args, inv, census, calls: int, shards: dict) -> dict:
    """Holds a request's collectives to the port's model and prints them:
    without a process group none; under one rank 0's seed broadcast, the
    UNet calls' (``_audit_faults``), the sp gather of the finished frames
    at sp and the dp gather of the samples, nothing else (so a dp request
    issues none inside its loop). Returns ``_audit_lines``'s."""
    import torch.distributed as dist

    from t2v_torch.parallel.audit import Inventory

    if not dist.is_initialized():
        if inv.ops:
            _fail(f"{label}: collectives without a process group: {inv.summary()}")
        return {}
    report = _audit_lines(label, inv)
    tp, sp = shards.get("tp_shards", 1), shards.get("sp_shards", 1)
    seed, *loop, gather = inv.ops
    faults = []
    if (seed.kind, seed.axis, gather.kind, gather.axis) != ("broadcast", "default",
                                                            "all-gather", "dp"):
        faults.append(f"{label}: the request does not open with the seed broadcast and close "
                      f"with the sample gather: {seed}, {gather}")
    if sp > 1:
        final = loop.pop()
        if (final.kind, final.axis, final.shapes[0][1]) != ("all-gather", "sp", args.frames):
            faults.append(f"{label}: not the gather of the finished frames: {final}")
    faults += _audit_faults(label, Inventory(loop), census, pipe.unet, tp, sp, calls,
                            args.frames)
    if faults:
        _fail("; ".join(faults))
    print(f"{label}: audit: the port's communication model holds ({len(inv.ops)} collectives, "
          f"{calls} UNet calls)", flush=True)
    return report


def _par_run(label, pipe, args, outdir: Path, per_call: dict, calls: int, decodes: int,
             **shards):
    """``run`` writing PNG frames under ``outdir``, the plain versions
    barred from CUDA tensors and its collectives recorded; fails unless the
    launches equal ``calls`` UNet calls plus ``decodes`` decode calls and
    the collectives follow the port's model (``_par_audit``). Returns
    (launches, seconds, the audit's lines)."""
    import torch

    from t2v_torch.core.config import T2VOutputArgs
    from t2v_torch.parallel import audit
    from t2v_torch.pipeline.run import run

    _reset_counters()
    t0 = time.perf_counter()
    with _no_plain_on_cuda(), audit.recording() as inv, audit.site_census(pipe.unet) as census:
        run(args, T2VOutputArgs(skip_video_creation=True), pipe=pipe, outdir=str(outdir),
            callback_interval=None, keep_in_vram=False, **shards)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _read_counters()
    expected = _expected(per_call, calls, decodes)
    if counts != expected:
        _fail(f"{label}: launch counts {counts} differ from the topology's {expected}")
    return counts, seconds, _par_audit(label, pipe, args, inv, census, calls, shards)


def _png_frames(outdir: Path) -> list:
    """The (F, H, W, 3) PNG frames of each batch ``run`` wrote, in batch order."""
    import cv2
    import numpy as np

    batches = sorted((d for d in outdir.iterdir() if d.is_dir()),
                     key=lambda d: (len(d.name), d.name))
    return [np.stack([cv2.imread(str(f)) for f in sorted(d.glob("*.png"))]) for d in batches]


def _frame_distance(got, want) -> tuple[int, float]:
    """(largest, mean) level difference of two uint8 frame stacks."""
    import numpy as np

    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float(d.mean())


def _rel_rms(got, want) -> float:
    """Relative RMS distance of two frame stacks."""
    import numpy as np

    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _par_fault_rms(pipe, args, outdir: Path, serial_frames) -> float:
    """The batched request ``args`` (``dp_shards=2`` in one process) with a
    fault planted in the batch: sample 1's cond and uncond context rows
    swapped at every UNet call (a wrong CFG pairing). Returns the relative
    RMS of sample 1's frames from the serial ones, which the frame gate
    must exceed for it to catch such a fault."""
    from t2v_torch.core.config import T2VOutputArgs
    from t2v_torch.pipeline.run import run

    n = args.batch_count

    def swap(mod, a, kw):
        ctx = a[2].clone()
        ctx[[1, n + 1]] = a[2][[n + 1, 1]]
        return (a[0], a[1], ctx, *a[3:]), kw

    handle = pipe.unet.register_forward_pre_hook(swap, with_kwargs=True)
    try:
        run(args, T2VOutputArgs(skip_video_creation=True), pipe=pipe, outdir=str(outdir),
            callback_interval=None, keep_in_vram=False, dp_shards=2)
    finally:
        handle.remove()
    return _rel_rms(_png_frames(outdir)[1], serial_frames[1])


def _par_captured(pipe, fn, calls) -> tuple:
    """``fn()`` and, at the UNet calls numbered ``calls``, that call's
    inputs and output."""
    kept, seen = [], [0]

    def hook(mod, a, kw, out):
        if seen[0] in calls:
            kept.append((a, kw, out))
        seen[0] += 1

    handle = pipe.unet.register_forward_hook(hook, with_kwargs=True)
    try:
        res = fn()
    finally:
        handle.remove()
    return res, kept


def _par_call_check(label, got, want) -> list:
    """Fails unless ``got`` is within TOL_SHARE of max |want| of it;
    returns [max abs error, limit]."""
    err = (got.float() - want.float()).abs().max().item()
    limit = TOL_SHARE * max(1.0, want.float().abs().max().item())
    print(f"{label}: max_abs_err={err:.3e} tol={limit:.3e} {'ok' if err <= limit else 'MISMATCH'}",
          flush=True)
    if not err <= limit:
        _fail(f"{label}: {err} above {limit}")
    return [err, limit]


def _gloo_cuda_probe(rank: int) -> None:
    """Print which collectives this torch build's gloo takes on CUDA
    tensors: ``parallel/mesh.py`` hands every group the tensors where they
    lie, so the sharded paths on one card need all three."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    probes = {"all_reduce": lambda: dist.all_reduce(x.clone()),
              "broadcast": lambda: dist.broadcast(x.clone(), 0),
              "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in
                                                      range(PAR_RANKS)], x)}
    for name, call in probes.items():
        try:
            call()
            torch.cuda.synchronize()
            answer = "takes CUDA tensors"
        except (RuntimeError, ValueError) as e:
            answer = f"refuses CUDA tensors ({str(e).splitlines()[0][:100]})"
        print(f"rank {rank}: gloo {name} {answer}", flush=True)


def _parallel_rank(rank: int, port: int, out: Path) -> int:
    """One of the two ranks (``--parallel-rank``): both drive cuda:0, so the
    group is gloo. Per family: a dp = 2 request (20 steps, one sample a
    rank at the serial loop's shapes); then, for tp = 2 and sp = 2, the
    one-rank UNet calls of a serial 4-step request held against the sharded
    calls on the same inputs, and the 4-step request through ``run``. Every
    ``run`` counts its launches against the topology's with the plain
    versions barred. Writes ``rank{rank}.json``."""
    import torch

    from t2v_torch.parallel import multihost
    from t2v_torch.parallel.mesh import get_mesh
    from t2v_torch.parallel.sharding import parallel_unet

    multihost.initialize(f"127.0.0.1:{port}", PAR_RANKS, rank)
    torch.cuda.set_device(multihost.rank_device())
    _gloo_cuda_probe(rank)
    report = {}
    try:
        for family in PAR_FAMILIES:
            torch.cuda.reset_peak_memory_stats()
            pipe = _par_pipeline(family)
            per_call = _par_per_call(pipe, family)
            steps = STEPS if family == "modelscope" else VC_STEPS
            rep = report[family] = {}
            counts, sec, traffic = _par_run(f"{family} dp=2 rank {rank}", pipe,
                                            _par_request(family, steps, 2), out / f"{family}_dp",
                                            per_call, steps, 2 if rank == 0 else 0, dp_shards=2)
            rep["dp"] = {"launches": counts, "seconds": sec, "audit": traffic}
            args4 = _par_request(family, PAR_STEPS)
            res4, calls = _par_captured(pipe, lambda: pipe.infer(args4), PAR_CALLS)
            frames4 = res4.frames
            for kind in ("tp", "sp"):
                mesh = get_mesh(**{kind: 2})
                errs = []
                for i, (a, kw, want) in zip(PAR_CALLS, calls):
                    x = mesh.sp.shard(a[0], 1) if kind == "sp" else a[0]
                    with torch.no_grad(), _no_plain_on_cuda(), parallel_unet(
                            pipe.unet, tp=mesh.tp if kind == "tp" else None,
                            sp=mesh.sp if kind == "sp" else None):
                        got = pipe.unet(x, *a[1:], **kw)
                    if kind == "sp":
                        got = mesh.sp.all_gather(got, 1)
                    errs.append(_par_call_check(f"rank {rank} {family} {kind}=2 UNet call {i}",
                                                got, want))
                counts, sec, traffic = _par_run(f"{family} {kind}=2 rank {rank}", pipe, args4,
                                                out / f"{family}_{kind}", per_call, PAR_STEPS,
                                                1 if rank == 0 else 0, **{f"{kind}_shards": 2})
                rep[kind] = {"calls": errs, "launches": counts, "seconds": sec, "audit": traffic}
                if rank == 0:
                    rep[kind]["frames_vs_serial"] = _frame_distance(  # PNGs are BGR
                        _png_frames(out / f"{family}_{kind}")[0], frames4[..., ::-1])
            rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            del pipe, calls
            _release()
    finally:
        multihost.shutdown()
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    return 0


def _par_env() -> dict:
    """The environment of the processes this group starts: gloo on the
    loopback interface."""
    import os

    env = dict(os.environ)
    if Path("/sys/class/net/lo").exists():
        env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_procs(label: str, cmds: list, logs: list,
               keep=("UNet call", "backend", "gloo", "audit", "Error")) -> None:
    """Start ``cmds`` together, each writing to its log, and wait for all
    of them; fails (after stopping the others) if one does not end with 0
    within PAR_TIMEOUT, printing the end of its log; a process that fails
    stops the others at once (its peers would wait in a collective). Prints
    the log lines holding a word of ``keep``."""
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                              env=_par_env(), cwd=REPO,
                                              start_new_session=True))
        deadline = time.monotonic() + PAR_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                _fail(f"{label}: not done within {PAR_TIMEOUT} s")
            time.sleep(0.5)
    finally:
        for p in procs:  # each leads a session of its own: its children go with it
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for log in logs:
            text = Path(log).read_text()
            kept = [ln for ln in text.splitlines() if any(w in ln for w in keep)]
            print(f"{label}: {Path(log).name}: " + ("\n  ".join([""] + kept) if kept else
                                                   "(no check lines)"), flush=True)
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs):
        tails = "\n".join(Path(log).read_text()[-3000:] for log in logs)
        _fail(f"{label}: exit codes {codes}\n{tails}")


def drive_parallel() -> dict:
    """Sharded sampling at full width (ModelScope 24f, VideoCrafter 16f).
    In this process, per family: two serial batches through ``run`` and the
    same request with ``dp_shards=2`` without a process group (one batched
    loop at CFG batch 4): its first, middle and last UNet calls held, per
    sample, against the serial call on the same rows within TOL_SHARE of
    max |out|, and its frames within TOL_SHARE relative RMS of the serial
    ones (the end of a 20-step chain carries each rounding difference of
    the batch-4 call on, so its largest level difference is printed, not
    gated); the same request with a fault planted in the batch
    (``_par_fault_rms``) must land beyond that frame limit.
    Then two ranks sharing the card (``--parallel-rank``): their dp = 2
    frames equal the serial ones; their tp = 2 and sp = 2 UNet calls agree
    with the one-rank calls (``_parallel_rank``). Then the CLI under
    torchrun (``python -m torch.distributed.run --standalone
    --nproc-per-node 2 -m t2v_torch.cli.generate --dp-shards 2``) on a
    directory saved from this process's ModelScope pipeline: rank 0 writes
    both batches once, equal to the serial ones. Returns the launches per
    path."""
    import shutil
    import tempfile

    import torch

    from t2v_torch.io.train_state import save_weights

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_par_", dir=REPO))
    launches, serial = {}, {}
    t_group = time.perf_counter()
    try:
        for family in PAR_FAMILIES:
            t0 = time.perf_counter()
            pipe = _par_pipeline(family)
            t_init = time.perf_counter() - t0
            per_call = _par_per_call(pipe, family)
            steps = STEPS if family == "modelscope" else VC_STEPS
            args = _par_request(family, steps, 2)
            _, sec_serial, _ = _par_run(f"{family} serial", pipe, args,
                                        root / f"{family}_serial", per_call, 2 * steps, 2)
            torch.cuda.reset_peak_memory_stats()
            batch_calls = (0, steps // 2, steps - 1)
            (counts, sec, _), calls = _par_captured(pipe, lambda: _par_run(
                f"{family} batched dp=2", pipe, args, root / f"{family}_batched", per_call, steps,
                2, dp_shards=2), batch_calls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches[f"{family}_batched"] = counts
            # each sample's rows of a batched call (uncond i, cond i) against
            # the serial loop's call on the same rows
            for step, (a, kw, out) in zip(batch_calls, calls):
                for i in range(args.batch_count):
                    rows = [i, args.batch_count + i]
                    with torch.no_grad(), _no_plain_on_cuda():
                        want = pipe.unet(*(t[rows] for t in a), **kw)
                    _par_call_check(f"{family} batched dp=2 UNet call {step}, sample {i}, "
                                    "against its serial call", out[rows], want)
            del calls
            serial[family] = _png_frames(root / f"{family}_serial")
            sound = []
            for i, (got, want) in enumerate(zip(_png_frames(root / f"{family}_batched"),
                                                serial[family])):
                big, mean = _frame_distance(got, want)
                rel = _rel_rms(got, want)
                sound.append(rel)
                print(f"{family} batched dp=2 (one process, CFG batch 4): batch {i} frames "
                      f"{got.shape} vs serial: relative RMS {rel:.3e} (limit {TOL_SHARE}), "
                      f"largest level difference {big}, mean {mean:.4f}", flush=True)
                if got.shape != want.shape or rel > TOL_SHARE:
                    _fail(f"{family} batched dp=2 batch {i}: {rel} from the serial frames")
            fault = _par_fault_rms(pipe, args, root / f"{family}_fault", serial[family])
            print(f"{family} batched dp=2 with a planted fault (sample 1's cond and uncond rows "
                  f"swapped): batch 1 frames vs serial: relative RMS {fault:.3e}, "
                  f"{fault / max(sound):.1f}x the sound run's largest; the gate "
                  f"(limit {TOL_SHARE}) {'catches it' if fault > TOL_SHARE else 'MISSES it'}",
                  flush=True)
            if not fault > TOL_SHARE:
                _fail(f"{family}: the batched frame gate passes a planted fault ({fault})")
            print(f"{family} batched dp=2: {sec / 2:.3f} s/video over {args.batch_count} videos "
                  f"(serial {sec_serial / 2:.3f}), peak {peak:.2f} GiB, random_init {t_init:.1f} "
                  f"s, launches {counts}", flush=True)
            if family == "modelscope":
                save_weights(str(root / "modelscope_dir"),
                             unet_params=dict(pipe.unet.named_parameters()), vae=pipe.vae,
                             clip=pipe.text_encoder.model, unet_cfg=pipe.unet_cfg,
                             vae_cfg=pipe.vae_cfg, clip_cfg=pipe.clip_cfg,
                             model_family="modelscope", tokenizer_vocab=str(VOCAB))
            del pipe
            _release()

        t0 = time.perf_counter()
        port = _free_port()
        _run_procs("two ranks", [[sys.executable, str(Path(__file__).resolve()), "--parallel-rank",
                                  str(r), "--port", str(port), "--out", str(root)]
                                 for r in range(PAR_RANKS)],
                   [root / f"rank{r}.log" for r in range(PAR_RANKS)])
        t_ranks = time.perf_counter() - t0
        reports = [json.loads((root / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
        for family in PAR_FAMILIES:
            for i, (got, want) in enumerate(zip(_png_frames(root / f"{family}_dp"),
                                                serial[family])):
                big, mean = _frame_distance(got, want)
                print(f"{family} dp=2 over two ranks: rank 0's batch {i} frames vs serial: "
                      f"largest level difference {big}, mean {mean:.4f} (must be 0)", flush=True)
                if big:
                    _fail(f"{family} dp=2 batch {i}: frames differ from the serial loop's")
            for kind in ("dp", "tp", "sp"):
                for r, rep in enumerate(reports):
                    k = rep[family][kind]
                    launches[f"{family}_{kind}2_rank{r}"] = k["launches"]
                    extra = (f", frames vs serial (largest, mean level difference) "
                             f"{k['frames_vs_serial']}" if "frames_vs_serial" in k else "")
                    print(f"{family} {kind}=2 rank {r}: {k['seconds']:.3f} s for the request"
                          f"{extra}, launches {k['launches']}", flush=True)
            print(f"{family}: peak per rank {[rep[family]['peak_gib'] for rep in reports]} GiB",
                  flush=True)
        print(f"two ranks: {t_ranks:.1f} s", flush=True)

        t0 = time.perf_counter()
        args = _par_request("modelscope", STEPS, 2)
        cli_out = root / "cli_out"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(PAR_RANKS), "-m", "t2v_torch.cli.generate",
               "--model-dir", str(root / "modelscope_dir"), "--prompt", args.prompt,
               "--n-prompt", args.n_prompt, "--seed", str(args.seed), "--steps", str(args.steps),
               "--frames", str(args.frames), "--width", str(PX), "--height", str(PX),
               "--cfg-scale", str(args.cfg_scale), "--batch-count", "2", "--dp-shards", "2",
               "--skip-video-creation", "--outdir", str(cli_out)]
        _run_procs("torchrun CLI", [cmd], [root / "cli.log"])
        written = sorted(cli_out.rglob("*.png"))
        frames = _png_frames(cli_out)
        print(f"torchrun CLI --dp-shards 2: {time.perf_counter() - t0:.1f} s, "
              f"{len(written)} PNGs in {len(frames)} batch directories", flush=True)
        if len(written) != 2 * T or len(frames) != 2:
            _fail(f"torchrun CLI: {len(written)} PNGs in {len(frames)} directories, expected "
                  f"{T} in each of 2 (written once, by rank 0)")
        for i, (got, want) in enumerate(zip(frames, serial["modelscope"])):
            big, mean = _frame_distance(got, want)
            print(f"torchrun CLI batch {i} vs serial: largest level difference {big}", flush=True)
            if big:
                _fail(f"torchrun CLI batch {i}: frames differ from the serial loop's")
        print(f"parallel group: {time.perf_counter() - t_group:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Training over a mesh (``--only meshtrain``): two ranks sharing the card over
# gloo at dp = 2, tp = 2 and sp = 2, the trainer CLI under torchrun, and the
# legacy blocks at UNetSD's widths

MT_RANKS = 2
MT_STEPS = 2
# a gradient leaf's distance from the one-rank step: max |g - g0| over
# max |g0| of the leaf, or over MT_GRAD_FLOOR of the tree's largest |g0|
# where the leaf's is smaller (a bias just ahead of a GroupNorm has a true
# gradient of 0, and bf16 noise there). In bf16 the worst of some 1,000
# leaves lands at 1-4.5% of its max |g| (the median at 0.05%): the limit
# keeps twice that, and the planted faults land 17x and more beyond it
MT_GRAD_SHARE = 0.1
MT_GRAD_FLOOR = 1e-2
# the first step's loss, relative: the bf16 mesh steps land within 2.3e-3 of
# the one-rank step. A rank on the wrong sample moves it by 3.9e-2, on the
# wrong frames by 9.5e-4 only (the share faults below): the gradients
# (MT_GRAD_SHARE) are the gate that sees frames
MT_LOSS_SHARE = 1e-2
# (label, family, "lora" | "full", the mesh axis of size 2, EMA decay, global batch)
MT_CASES = (
    ("ms_lora_dp", "modelscope", "lora", "dp", None, 2),
    ("ms_lora_tp", "modelscope", "lora", "tp", None, 1),
    ("ms_lora_sp", "modelscope", "lora", "sp", None, 1),
    ("ms_full_dp", "modelscope", "full", "dp", 0.9999, 2),
    ("vc_full_tp", "videocrafter", "full", "tp", None, 1),
    ("vc_full_sp", "videocrafter", "full", "sp", None, 1),
)
# the planted faults, each on the case it names: LoRA at tp = 2 without the
# tp sum of its factors' gradients; VideoCrafter at sp = 2 with the
# GroupNorm sums' backward taken as the identity
MT_FAULTS = {"ms_lora_tp": "no tp sum of the LoRA factors' gradients",
             "vc_full_sp": "identity backward on the sp GroupNorm sums"}
# the planted faults of a wrong share: every rank takes the first share of
# the global batch (as a trainer that split its batch or frames wrongly
# would); the loss or the gradient gate must catch each
MT_SHARE_FAULTS = {"ms_lora_dp": "both dp ranks train on the first sample",
                   "vc_full_sp": "both sp ranks take the first frames"}
MT_CLI_STEPS = 2


# the case in which one row-parallel site is planted to gather its full
# weight at every call (``_gather_fault``): the numeric gates pass it, the
# audit must not
MT_GATHER_FAULT = "vc_full_tp"


@contextlib.contextmanager
def _gather_fault(unet, layout: dict, tp):
    """While the block is open, the first row-parallel attention of
    ``unet`` also gathers its full out-projection weight from its tp pieces
    (``sharding.gather_tensor``) at every call, and drops it."""
    from t2v_torch.parallel.sharding import gather_tensor

    name = next(n for n in layout if n.endswith("to_out.0.weight"))
    site = unet.get_submodule(name.removesuffix(".to_out.0.weight"))

    def gather_and_drop(mod, args):
        gather_tensor(mod.to_out[0].weight, name, layout, tp)

    handle = site.register_forward_pre_hook(gather_and_drop)
    try:
        yield
    finally:
        handle.remove()


def _mt_inputs(pipe, family: str, batch: int, seed: int):
    """A case's global batch (seeded clips through ``compute_latents``,
    captions through the text tower) and its global (t, noise) draw."""
    import torch

    clips = _synthetic_clips(seed, batch)
    captions = [_CAPTIONS[i % len(_CAPTIONS)] for i in range(batch)]
    with torch.no_grad(), _no_plain_on_cuda():
        latents = torch.cat([pipe.compute_latents(c) for c in clips], dim=0)
        context = (pipe.encode_text(captions) if family == "videocrafter" else
                   torch.stack([pipe.text_encoder.encode_line(c) for c in captions]))
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randint(0, pipe.schedule.num_timesteps, (batch,), generator=g, device="cuda")
    noise = torch.randn(latents.shape, generator=g, device="cuda")
    return {"latents": latents, "context": context}, (t, noise)


def _mt_lora(pipe, seed: int):
    """(a rank-4 LoRA tree, the module index): A as ``init_lora`` draws it,
    B given signal (at zero it would zero every gradient of A)."""
    import torch

    from t2v_torch.pipeline import lora as L

    index = L.unet_module_index(pipe.unet_cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = L.init_lora(dict(pipe.unet.named_parameters()), index, 4, g)
    with torch.no_grad():
        for ab in tree.values():
            ab["lora_B"].copy_(0.02 * torch.randn(ab["lora_B"].shape, generator=g,
                                                  device="cuda"))
    return tree, index


def _mt_step(pipe, kind: str, mesh, ema, lora):
    """(state, step, tp layout) of a case on ``mesh`` (None: one rank)."""
    from t2v_torch.parallel import train as T
    from t2v_torch.parallel.sharding import tp_layout

    cfg = pipe.cfg if hasattr(pipe, "clip") else pipe.unet_cfg
    layout = tp_layout(pipe.unet, mesh.tp.size) if mesh is not None else {}
    apply_fn = T.module_apply_fn(pipe.unet, mesh)
    opt = T.make_optimizer(1e-4, 1e-2)
    base = dict(pipe.unet.named_parameters())
    if kind == "lora":
        tree, index = lora
        state = T.init_train_state(tree, opt, mesh)
        step = T.make_lora_train_step(apply_fn, pipe.schedule, base, index, mesh,
                                      parameterization=cfg.parameterization, layout=layout)
    else:
        state = T.init_train_state(base, opt, mesh, with_ema=ema is not None, layout=layout)
        step = T.make_train_step(apply_fn, pipe.schedule, mesh, ema_decay=ema,
                                 parameterization=cfg.parameterization)
    return state, step, layout


def _mt_distance(got: dict, want: dict) -> dict:
    """The gradient gate's reading of ``got`` (on the card) against
    ``want`` (the one-rank step's, on the host): the worst leaf's distance
    (the ``MT_GRAD_SHARE`` comment), its name, and the median leaf's."""
    top = max(w.abs().max().item() for w in want.values())
    dist = {}
    for name, w in want.items():
        w = w.to(got[name].device)
        err = (got[name].float() - w.float()).abs().max().item()
        dist[name] = err / max(w.abs().max().item(), MT_GRAD_FLOOR * top)
    worst = max(dist, key=dist.get)
    return {"worst": dist[worst], "leaf": worst, "median": sorted(dist.values())[len(dist) // 2],
            "leaves": len(dist)}


def _mt_case(rank: int, pipe, per_call: dict, case: tuple, seed: int, failures: list) -> dict:
    """One case on this rank: rank 0 takes the one-rank step's loss and
    gradients on the global batch and draw (the other rank waits); then
    both ranks run MT_STEPS mesh steps on their shares (the first on the
    same draw, split into ``loss_and_grads`` and ``apply_gradients``),
    counting launches and collective traffic; the first step's gradients
    are gathered and rank 0 holds them and the loss against the one-rank
    step; then the planted fault, where the case has one. Appends to
    ``failures`` what does not hold (the EMA rule on one leaf too), so that
    both ranks run every case and the collectives stay paired."""
    import torch
    import torch.distributed as dist

    from t2v_torch.parallel import audit
    from t2v_torch.parallel import train as T
    from t2v_torch.parallel.mesh import AXES, Axis, get_mesh
    from t2v_torch.parallel.sharding import gather_params

    label, family, kind, axis, ema, batch = case
    mesh = get_mesh(**{axis: 2})
    glob, draw = _mt_inputs(pipe, family, batch, seed)
    lora = _mt_lora(pipe, seed) if kind == "lora" else None
    base_before = _fingerprint(pipe.unet.parameters())
    ref = None
    if rank == 0:
        state, step, _ = _mt_step(pipe, kind, None, None, lora)
        with _no_plain_on_cuda():
            loss0, grads0 = step.loss_and_grads(state, glob, None, draw)
        ref = (float(loss0), {n: g.cpu() for (n, _), g in zip(T.tree_items(state.params),
                                                              grads0)})
        del state, step, grads0
        _release()
    dist.barrier()

    torch.cuda.reset_peak_memory_stats()
    state, step, layout = _mt_step(pipe, kind, mesh, ema, lora)
    names = [n for n, _ in T.tree_items(state.params)]
    local = T.local_batch(mesh, glob)
    before = _fingerprint(T.tree_leaves(state.params))
    ema_name = names[0] if ema is not None else None
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    times, losses, rep = [], [], {}
    _reset_counters()
    with _no_plain_on_cuda(), audit.recording() as inv, audit.site_census(pipe.unet) as census:
        for i in range(MT_STEPS):
            if ema_name is not None:
                ema_old = state.ema_params[ema_name].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                loss, first = step.loss_and_grads(state, local, gen, draw)
                step.apply_gradients(state, first)
            else:
                state, loss = step(state, local, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if i == 0:  # the first step's gradients, whole, against the one-rank step's
                full = gather_params(dict(zip(names, first)), layout, mesh.tp)  # save phase
                if rank == 0:
                    rep["grads"] = _mt_distance(full, ref[1])
                del full, first
            if ema_name is not None:
                want = (ema_old * ema + state.params[ema_name].detach().float() * (1.0 - ema))
                if not torch.allclose(state.ema_params[ema_name], want, rtol=1e-5, atol=1e-7):
                    failures.append(f"{label}: EMA of {ema_name} is not decay * old + "
                                    "(1 - decay) * new")
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = _fingerprint(T.tree_leaves(state.params))
    moved = bool(torch.isfinite(after).all()) and not torch.equal(before, after)
    same_base = torch.equal(base_before, _fingerprint(pipe.unet.parameters()))
    tag = f"meshtrain {label} rank {rank}"
    # the model's gradient sums: one float32 pass of every trainable leaf of
    # the rank (and the loss) over each of sp and dp above 1; under tp the
    # leaves a tp slice feeds
    numel = sum(p.numel() for p in T.tree_leaves(state.params))
    summed = sum(p.numel() for n, p in T.tree_items(state.params) if n in step.tp_summed)
    want_sums = {ax: MT_STEPS * (4 * numel + 4) for ax in ("sp", "dp") if mesh.shape[ax] > 1}
    if mesh.tp.size > 1 and summed:
        want_sums["tp"] = MT_STEPS * 4 * summed
    del state
    _release()
    sums = inv.select(phases=("gradient sum",))
    got_sums = {ax: sum(op.bytes for op in sums.ops if op.axis == ax) for ax in AXES}
    audit_faults = _audit_faults(tag, inv, census, pipe.unet, mesh.tp.size, mesh.sp.size,
                                 MT_STEPS, TRAIN_T)
    if {ax: b for ax, b in got_sums.items() if b} != want_sums:
        audit_faults.append(f"{tag}: gradient sums {got_sums} B, the model's {want_sums}")
    failures.extend(audit_faults)
    step_ops = inv.select(phases=("forward", "backward", "gradient sum"))

    expected = {k: 0 for k in _counters()}
    expected.update({k: MT_STEPS * v for k, v in per_call.items()})
    expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = MT_STEPS * per_call["flash_attention"]
    rep.update(seconds=times, losses=losses, peak_gib=peak, launches=counts,
               audit=_audit_lines(tag, step_ops),
               reduced_bytes_per_step=step_ops.total_bytes["all-reduce"] / MT_STEPS,
               gathered_bytes_per_step=step_ops.total_bytes["all-gather"] / MT_STEPS)
    if rank == 0:
        loss_err = abs(losses[0] - ref[0]) / abs(ref[0])
        rep.update(loss_ref=ref[0], loss_err=loss_err)

    if label in MT_FAULTS:
        state, step, _ = _mt_step(pipe, kind, mesh, ema, lora)
        sound = Axis.all_reduce_sum
        if kind == "lora":
            step.tp_summed = frozenset()
        else:
            Axis.all_reduce_sum = lambda self, t, backward: sound(self, t, "identity")
        try:
            _, grads = step.loss_and_grads(state, local, None, draw)
        finally:
            Axis.all_reduce_sum = sound
        fault = gather_params(dict(zip(names, grads)), layout, mesh.tp)
        if rank == 0:
            rep["fault"] = _mt_distance(fault, ref[1])
        del state, step, grads, fault
        _release()

    if label == MT_GATHER_FAULT:
        state, step, _ = _mt_step(pipe, kind, mesh, ema, lora)
        with _no_plain_on_cuda(), audit.recording() as planted, \
                _gather_fault(pipe.unet, layout, mesh.tp):
            wrong, grads = step.loss_and_grads(state, local, None, draw)
        fault = gather_params(dict(zip(names, grads)), layout, mesh.tp)
        try:
            audit.assert_no_param_gather(planted, audit.param_full_shapes(pipe.unet))
            caught = None
        except AssertionError as e:
            caught = str(e)
        rep["gather_fault"] = {"loss": float(wrong), "caught": caught,
                               "traffic": _audit_lines(f"{tag} planted gather", planted)}
        if rank == 0:
            rep["gather_fault"].update(loss_err=abs(float(wrong) - ref[0]) / abs(ref[0]),
                                       grads=_mt_distance(fault, ref[1]))
        del state, step, grads, fault
        _release()

    if label in MT_SHARE_FAULTS:
        state, step, _ = _mt_step(pipe, kind, mesh, ema, lora)
        n, f = batch // mesh.dp.size, TRAIN_T // mesh.sp.size
        first = {"latents": glob["latents"][:n, :f].contiguous(),
                 "context": glob["context"][:n].contiguous()}
        wrong, grads = step.loss_and_grads(state, first, None, draw)
        fault = gather_params(dict(zip(names, grads)), layout, mesh.tp)
        if rank == 0:
            rep["share_fault"] = {"loss": abs(float(wrong) - ref[0]) / abs(ref[0]),
                                  "grads": _mt_distance(fault, ref[1])}
        del state, step, grads, fault
        _release()

    print(f"{tag}: {batch} x {TRAIN_T} frames ({local['latents'].shape[0]} x "
          f"{local['latents'].shape[1]} on this rank); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; seconds a step "
          f"{', '.join(f'{x:.3f}' for x in times)}; peak {peak:.2f} GiB; all-reduced "
          f"{rep['reduced_bytes_per_step'] / 1e9:.4f} GB and all-gathered "
          f"{rep['gathered_bytes_per_step'] / 1e9:.4f} GB a step; launches {counts}", flush=True)
    if rank == 0:
        g = rep["grads"]
        print(f"{tag}: first step against the one-rank step: loss {losses[0]:.5f} vs "
              f"{ref[0]:.5f} ({loss_err:.2e}, limit {MT_LOSS_SHARE}); gradients of "
              f"{g['leaves']} leaves: worst {g['worst']:.4f} ({g['leaf']}), median "
              f"{g['median']:.4f}, limit {MT_GRAD_SHARE}", flush=True)
        if "share_fault" in rep:
            f = rep["share_fault"]
            caught = f["loss"] > MT_LOSS_SHARE or f["grads"]["worst"] > MT_GRAD_SHARE
            print(f"{tag}: planted fault ({MT_SHARE_FAULTS[label]}): the first loss "
                  f"{f['loss']:.2e} from the one-rank step's (limit {MT_LOSS_SHARE}), "
                  f"gradients worst {f['grads']['worst']:.4f} ({f['grads']['leaf']}), median "
                  f"{f['grads']['median']:.4f} (limit {MT_GRAD_SHARE}): the gates "
                  f"{'catch it' if caught else 'MISS it'}", flush=True)
            if not caught:
                failures.append(f"{tag}: the loss and gradient gates pass the planted fault "
                                f"({f})")
        if "fault" in rep:
            f = rep["fault"]
            print(f"{tag}: planted fault ({MT_FAULTS[label]}): worst {f['worst']:.4f} "
                  f"({f['leaf']}), median {f['median']:.4f}, limit {MT_GRAD_SHARE}: the gate "
                  f"{'catches it' if f['worst'] > MT_GRAD_SHARE else 'MISSES it'}", flush=True)
            if not f["worst"] > MT_GRAD_SHARE:
                failures.append(f"{tag}: the gradient gate passes the planted fault "
                                f"({f['worst']})")
        if "gather_fault" in rep:
            f = rep["gather_fault"]
            passes = f["loss_err"] <= MT_LOSS_SHARE and f["grads"]["worst"] <= MT_GRAD_SHARE
            print(f"{tag}: planted fault (a row-parallel site gathers its full weight at every "
                  f"call): loss {f['loss_err']:.2e} from the one-rank step's, gradients worst "
                  f"{f['grads']['worst']:.4f}: the numeric gates "
                  f"{'pass it' if passes else 'CATCH it'}; the audit "
                  f"{'catches it: ' + f['caught'] if f['caught'] else 'MISSES it'}", flush=True)
            if not passes:
                failures.append(f"{tag}: the planted weight gather changed the step ({f})")
        if not (loss_err <= MT_LOSS_SHARE and g["worst"] <= MT_GRAD_SHARE):
            failures.append(f"{tag}: the mesh step is not the one-rank step (loss {loss_err}, "
                            f"gradients {g})")
    if "gather_fault" in rep and not rep["gather_fault"]["caught"]:
        failures.append(f"{tag}: the audit passes a per-call weight gather")
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{tag}: a loss is not finite: {losses}")
    if not moved:
        failures.append(f"{tag}: the trained leaves did not change, or are not finite")
    if not same_base:
        failures.append(f"{tag}: the pipeline's own weights changed")
    if counts != expected:
        failures.append(f"{tag}: launch counts {counts} differ from the topology's {expected}")
    return rep


def _meshtrain_rank(rank: int, port: int, out: Path) -> int:
    """One of the two ranks (``--meshtrain-rank``): both drive cuda:0 over
    gloo. Per family, one full-width pipeline and its cases of
    ``MT_CASES``. Writes ``meshtrain{rank}.json``, then fails if a case
    did not hold."""
    import torch

    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites
    from t2v_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", MT_RANKS, rank)
    torch.cuda.set_device(multihost.rank_device())
    report, failures = {}, []
    try:
        for family in PAR_FAMILIES:
            t0 = time.perf_counter()
            pipe = _par_pipeline(family)
            per_call = (count_kernel_sites(pipe.unet_cfg, TRAIN_T, LAT, LAT)
                        if family == "modelscope" else
                        count_vc_kernel_sites(pipe.cfg, TRAIN_T, LAT, LAT))
            print(f"meshtrain rank {rank}: {family} pipeline in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for i, case in enumerate(c for c in MT_CASES if c[1] == family):
                report[case[0]] = _mt_case(rank, pipe, per_call, case, 51 + i, failures)
            del pipe
            _release()
    finally:
        multihost.shutdown()
    (out / f"meshtrain{rank}.json").write_text(json.dumps(report))
    if failures:
        _fail("meshtrain: " + "; ".join(failures))
    return 0


def _write_clip_dir(root: Path, n: int = 2) -> Path:
    """A WebVid directory of ``n`` seeded TRAIN_T-frame 256x256 clips
    (``videos/<id>.mp4`` through cv2's mp4v writer, and ``meta.csv``)."""
    import csv

    import cv2
    import numpy as np

    (root / "videos").mkdir(parents=True)
    clips = ((_synthetic_clips(61, n) + 1.0) * 127.5).astype(np.uint8)
    with open(root / "meta.csv", "w", newline="") as f:
        rows = csv.writer(f)
        rows.writerow(["videoid", "name", "page_dir"])
        for i, clip in enumerate(clips):
            writer = cv2.VideoWriter(str(root / "videos" / f"{i}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 8, (PX, PX))
            for frame in clip:
                writer.write(np.ascontiguousarray(frame[..., ::-1]))
            writer.release()
            rows.writerow([str(i), _CAPTIONS[i % len(_CAPTIONS)], ""])
    return root


def _cli_rank(out: Path, argv: list, save: bool) -> int:
    """One process of the trainer CLI (``--cli-args``, under torchrun or
    alone): ``t2v_torch.cli.train.main(argv)`` with the plain versions
    barred from CUDA tensors and the launch counters set to 0 before it;
    writes ``rank{RANK}.json`` under ``out`` (the exit code, the launches,
    every step's loss) and, from rank 0, the first step's gradients, whole,
    to ``grads.pt``. The CLI's random pipeline gets its zero leaves
    perturbed, as every meshtrain case's does (with a zero output layer
    the first loss would not depend on the data). ``save=False`` skips the
    CLI's writes (the one-rank reference run)."""
    import torch

    from t2v_torch.cli import train as cli
    from t2v_torch.io import train_state as io_state
    from t2v_torch.parallel import train as T
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    rank = int(os.environ.get("RANK", "0"))
    if not save:
        io_state.save_train_state = io_state.save_weights = lambda *a, **k: None
    init = VideoCrafterPipeline.random_init

    def perturbed(*args, **kwargs):  # as _par_pipeline: no zero output layer
        pipe = init(*args, **kwargs)
        _perturb_zero_leaves(pipe)
        return pipe

    losses, loss_and_grads = [], T.TrainStep.loss_and_grads

    def recorded(self, state, *args, **kwargs):
        loss, grads = loss_and_grads(self, state, *args, **kwargs)
        losses.append(float(loss))
        if len(losses) == 1:  # every rank joins the gather; rank 0 writes
            names = [n for n, _ in T.tree_items(state.params)]
            full = io_state.full_tensors(state, dict(zip(names, grads)))
            if full is not None:
                torch.save({k: v.cpu() for k, v in full.items()}, out / "grads.pt")
            del full
        return loss, grads

    VideoCrafterPipeline.random_init = staticmethod(perturbed)
    T.TrainStep.loss_and_grads = recorded
    _reset_counters()
    with _no_plain_on_cuda():
        code = cli.main(argv)
    (out / f"rank{rank}.json").write_text(json.dumps(
        {"code": code, "launches": _read_counters(), "losses": losses}))
    return code


def _mt_cli(root: Path) -> dict:
    """``t2v_torch.cli.train --model-type VideoCrafter --sp 2`` under
    ``python -m torch.distributed.run --standalone --nproc-per-node 2`` on
    seeded clips: MT_CLI_STEPS steps saved at the end, then ``--resume`` to
    one more; and once in one process without ``--sp`` for one step, its
    writes skipped: the reference. Each process runs the CLI's ``main``
    through this script (``--cli-args``, ``_cli_rank``), which bars the
    plain versions and counts launches. Checks each rank's launches
    against the topology's (the sp-local training steps plus the VAE
    encoder's attention on the rank's frames), that both ranks report the
    same losses, the first step's loss and gradients against the
    reference's within MT_LOSS_SHARE and MT_GRAD_SHARE (a rank that
    encoded the wrong samples or frames moves them: ``_mt_case``'s share
    faults), that rank 0 wrote each ``step_N/``
    once and that the first loads through ``VideoCrafterPipeline.
    from_model_dir`` with every UNet weight at the full config's shape.
    Returns the launches per call and rank."""
    import shutil

    import torch

    from t2v_torch.core.config import VideoCrafterUNetConfig
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.io.train_state import load_weights
    from t2v_torch.models.videocrafter_unet import VideoCrafterUNet, count_vc_kernel_sites
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    data, out = _write_clip_dir(root / "clips"), root / "cli_out"
    argv = ["--model-type", "VideoCrafter", "--data-dir", str(data), "--out", str(out),
            "--batch-size", "1", "--frames", str(TRAIN_T), "--resolution", str(PX),
            "--log-every", "1", "--save-every", str(MT_CLI_STEPS)]
    me = str(Path(__file__).resolve())
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(MT_RANKS), me]
    calls = {  # label: (command, its arguments, ranks, steps it runs, frames a rank encodes)
        "reference": ([sys.executable, me], ["--steps", "1"], 1, 1, TRAIN_T),
        "train": (torchrun, ["--sp", "2", "--steps", str(MT_CLI_STEPS)], MT_RANKS,
                  MT_CLI_STEPS, TRAIN_T // 2),
        "resume": (torchrun, ["--sp", "2", "--steps", str(MT_CLI_STEPS + 1), "--resume"],
                   MT_RANKS, 1, TRAIN_T // 2),
    }
    per_call = count_vc_kernel_sites(VideoCrafterUNetConfig(), TRAIN_T, LAT, LAT)
    seconds, launches, losses = {}, {}, {}
    for label, (cmd, extra, ranks, steps, frames) in calls.items():
        where = root / f"cli_{label}"
        where.mkdir()
        args = ["--cli-args", json.dumps(argv + extra), "--out", str(where)]
        if label == "reference":
            args.append("--cli-no-save")
        t0 = time.perf_counter()
        _run_procs(f"torchrun trainer CLI ({label})", [cmd + args], [root / f"cli_{label}.log"],
                   keep=("step ", "saved", "resumed", "mesh", "Error"))
        seconds[label] = time.perf_counter() - t0
        expected = {k: 0 for k in _counters()}
        expected.update({k: steps * v for k, v in per_call.items()})
        expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = steps * per_call["flash_attention"]
        expected["flash_attention"] += steps * -(-frames // 8)  # the VAE encoder's attention
        reports = [json.loads((where / f"rank{r}.json").read_text()) for r in range(ranks)]
        for r, rep in enumerate(reports):
            launches[f"meshtrain_cli_{label}_rank{r}"] = rep["launches"]
            if rep["code"] != 0 or len(rep["losses"]) != steps:
                _fail(f"trainer CLI ({label}) rank {r}: exit code {rep['code']}, "
                      f"{len(rep['losses'])} steps, expected {steps}")
            if rep["launches"] != expected:
                _fail(f"trainer CLI ({label}) rank {r}: launch counts {rep['launches']} differ "
                      f"from the topology's {expected}")
            if not all(math.isclose(a, b, rel_tol=1e-6) for a, b in
                       zip(rep["losses"], reports[0]["losses"])):
                _fail(f"trainer CLI ({label}): the ranks report different losses "
                      f"{[x['losses'] for x in reports]}")
        losses[label] = reports[0]["losses"]
    loss_err = abs(losses["train"][0] - losses["reference"][0]) / abs(losses["reference"][0])
    g = _mt_distance(torch.load(root / "cli_train" / "grads.pt", map_location="cuda"),
                     torch.load(root / "cli_reference" / "grads.pt"))
    print(f"trainer CLI (VideoCrafter, sp = 2): first step against one process's on the same "
          f"clips and seed: loss {losses['train'][0]:.5f} vs {losses['reference'][0]:.5f} "
          f"({loss_err:.2e}, limit {MT_LOSS_SHARE}); gradients of {g['leaves']} leaves: worst "
          f"{g['worst']:.4f} ({g['leaf']}), median {g['median']:.4f}, limit {MT_GRAD_SHARE}; "
          f"losses {losses['train']} then {losses['resume']} after --resume; launches a rank "
          f"{launches['meshtrain_cli_train_rank0']}", flush=True)
    if not (loss_err <= MT_LOSS_SHARE and g["worst"] <= MT_GRAD_SHARE):
        _fail(f"trainer CLI: the sp = 2 run's first step is not one process's (loss "
              f"{loss_err}, gradients {g})")
    _release()
    log = (root / "cli_resume.log").read_text()
    if f"at step {MT_CLI_STEPS}" not in log:
        _fail(f"torchrun trainer CLI: --resume did not continue at step {MT_CLI_STEPS}")
    saved = sorted(p.name for p in out.iterdir())
    want_saved = [f"step_{MT_CLI_STEPS}", f"step_{MT_CLI_STEPS + 1}"]
    if saved != want_saved:
        _fail(f"torchrun trainer CLI: wrote {saved}, expected {want_saved}")
    for name in want_saved:
        step = json.loads((out / name / "train_state.json").read_text())["step"]
        if step != int(name.split("_")[1]):
            _fail(f"torchrun trainer CLI: {name} holds a state at step {step}")
    # a random-init pipeline has no vocab file to save beside its weights:
    # the repo's test vocab, under the published name in the parent
    # directory, where the loaders look
    shutil.copy(VOCAB, out / "bpe_simple_vocab_16e6.txt.gz")
    _, sds = load_weights(str(out / want_saved[0]), only=("unet",))
    with torch.device("meta"):
        full_shapes = {k: v.shape for k, v in VideoCrafterUNet(VideoCrafterUNetConfig())
                       .state_dict().items()}
    if {k: v.shape for k, v in sds["unet"].items()} != full_shapes:
        _fail("torchrun trainer CLI: the saved UNet is not at the full config's shapes")
    t0 = time.perf_counter()
    pipe = VideoCrafterPipeline.from_model_dir(str(out / want_saved[0]), Policy.bf16(),
                                               device="cuda")
    loaded = {k: v.shape for k, v in pipe.unet.state_dict().items()}
    seconds["load"] = time.perf_counter() - t0
    if loaded != full_shapes:
        _fail("torchrun trainer CLI: the loaded pipeline's UNet is not at the full shapes")
    print(f"torchrun trainer CLI (VideoCrafter, sp = 2): {MT_CLI_STEPS} steps "
          f"{seconds['train']:.1f} s, --resume to step {MT_CLI_STEPS + 1} "
          f"{seconds['resume']:.1f} s (each with both ranks' pipeline builds and rank 0's "
          f"writes), the one-process reference step {seconds['reference']:.1f} s; wrote "
          f"{saved} once; {want_saved[0]} loads through from_model_dir in "
          f"{seconds['load']:.1f} s, {len(loaded)} UNet tensors at the full shapes", flush=True)
    del pipe
    _release()
    return launches


def check_legacy() -> dict:
    """The legacy blocks at UNetSD's first level (320 channels, a 32x32
    map): the attention block (5 heads of 64 over 1,024 tokens and 77
    prepended context rows of 1,024: the flash kernel at S = 1,101) in bf16
    on the card, its flash call held against ``flash_attention_plain`` on
    the call's own inputs; the residual block (320 -> 640 channels,
    downsampling, the scale-shift embedding) in bf16 on the card against
    float32 on the CPU, within SMALL_RATIO of bf16 on the CPU. Returns the
    attention block's launches."""
    import copy

    import torch

    from t2v_torch.kernels import attention as attention_mod
    from t2v_torch.kernels.flash_attention import flash_attention_plain
    from t2v_torch.models import legacy as Lg
    from t2v_torch.pipeline.pipeline import init_weights

    g = torch.Generator().manual_seed(41)
    rnd = lambda *shape: torch.randn(shape, generator=g)

    def on(module, dtype, device):
        return copy.deepcopy(module).to(device=device, dtype=dtype).eval()

    attn = Lg.LegacyAttentionBlock(320, 1024, num_heads=5)
    res = Lg.LegacyResidualBlock(320, 1280, 640, use_scale_shift_norm=True, mode="downsample")
    for i, block in enumerate((attn, res)):
        init_weights(block, 41 + i)
        with torch.no_grad():  # the zero-initialised closing layers and the biases
            for p in block.parameters():
                p.add_(0.02 * rnd(*p.shape))
    x, ctx, e = rnd(2, LAT, LAT, 320), rnd(2, 77, 1024), rnd(2, 1280)

    calls, flash = [], attention_mod.flash_attention

    def recorded(q, k, v, scale=None):
        out = flash(q, k, v, scale)
        calls.append((q, k, v, scale, out))
        return out

    attention_mod.flash_attention = recorded
    _reset_counters()
    try:
        with torch.no_grad(), _no_plain_on_cuda():
            y = on(attn, torch.bfloat16, "cuda")(x.cuda().bfloat16(), ctx.cuda().bfloat16())
        torch.cuda.synchronize()
    finally:
        attention_mod.flash_attention = flash
    launches = _read_counters()
    if launches["flash_attention"] != 1 or len(calls) != 1 or sum(launches.values()) != 1:
        _fail(f"legacy attention block: launches {launches}, {len(calls)} flash calls; "
              "expected one flash launch")
    q, k, v, scale, out = calls[0]
    err = (out.float() - flash_attention_plain(q, k, v, scale).float()).abs().max().item()
    limit = TOL_SHARE * max(1.0, out.float().abs().max().item())
    with torch.no_grad():
        want = on(attn, torch.float32, "cpu")(x, ctx)
    rel = ((y.float().cpu() - want).norm() / want.norm()).item()
    print(f"legacy attention block (2, {LAT}, {LAT}, 320), 5 heads of 64, 77 context rows: "
          f"flash call {tuple(q.shape)} x {tuple(k.shape)}: max_abs_err={err:.3e} tol="
          f"{limit:.3e} {'ok' if err <= limit else 'MISMATCH'}; the block in bf16 on the card "
          f"{rel:.3e} relative RMS from float32 on the CPU", flush=True)
    if not err <= limit:
        _fail(f"legacy attention block: the flash call is {err} from its plain version")

    with torch.no_grad():
        want = on(res, torch.float32, "cpu")(x, e)
        cpu16 = on(res, torch.bfloat16, "cpu")(x.bfloat16(), e.bfloat16()).float()
        got = on(res, torch.bfloat16, "cuda")(x.cuda().bfloat16(), e.cuda().bfloat16())
    rel = lambda a: ((a.float().cpu() - want).norm() / want.norm()).item()
    card, floor = rel(got), rel(cpu16)
    ok = card <= SMALL_RATIO * floor
    print(f"legacy residual block (2, {LAT}, {LAT}, 320) -> (2, {LAT // 2}, {LAT // 2}, 640): "
          f"bf16 on the card {card:.3e} relative RMS from float32 on the CPU, bf16 on the CPU "
          f"{floor:.3e}, limit {SMALL_RATIO * floor:.3e} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        _fail(f"legacy residual block: {card} from float32, above {SMALL_RATIO} x {floor}")
    _release()
    return launches


def drive_meshtrain() -> dict:
    """Training over a mesh at full width (bf16, batch x 16 frames at
    256x256, seeded weights with the zero leaves perturbed): the legacy
    blocks in this process; then two ranks sharing the card over gloo
    (``--meshtrain-rank``) run ``MT_CASES`` (ModelScope LoRA rank 4 at
    dp = 2, tp = 2 and sp = 2; ModelScope full with EMA 0.9999 at dp = 2;
    VideoCrafter full at tp = 2 and sp = 2), each held against the one-rank
    step with its planted faults caught (``_mt_case``); then the trainer CLI
    under torchrun (``_mt_cli``). Returns the launches per path and rank."""
    import shutil
    import tempfile

    t_group = time.perf_counter()
    launches = {"legacy_attention": check_legacy()}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mt_", dir=REPO))
    try:
        t0 = time.perf_counter()
        port = _free_port()
        _run_procs("meshtrain ranks", [[sys.executable, str(Path(__file__).resolve()),
                                        "--meshtrain-rank", str(r), "--port", str(port),
                                        "--out", str(root)] for r in range(MT_RANKS)],
                   [root / f"meshtrain{r}.log" for r in range(MT_RANKS)],
                   keep=("meshtrain", "backend", "Error"))
        t_ranks = time.perf_counter() - t0
        reports = [json.loads((root / f"meshtrain{r}.json").read_text())
                   for r in range(MT_RANKS)]
        for label, *_ in MT_CASES:
            for r, rep in enumerate(reports):
                launches[f"meshtrain_{label}_rank{r}"] = rep[label]["launches"]
        print(f"meshtrain ranks: {t_ranks:.1f} s", flush=True)
        launches.update(_mt_cli(root))
        print(f"meshtrain group: {time.perf_counter() - t_group:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    phases = ("kernels", "small", "modelscope", "generate", "modes", "videocrafter",
              "vcgenerate", "vcbranches", "parallel", "train", "meshtrain")
    parser.add_argument("--only", help="run the build and these groups of phases (comma-"
                        f"separated, of {', '.join(phases)}, or vcddpm, which the default run "
                        "leaves out); prints no result line")
    # one rank of the parallel group, started by drive_parallel, or of the
    # meshtrain group, started by drive_meshtrain
    parser.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--meshtrain-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    # one process of the trainer CLI, started by _mt_cli: its arguments as
    # a JSON list
    parser.add_argument("--cli-args", help=argparse.SUPPRESS)
    parser.add_argument("--cli-no-save", action="store_true", help=argparse.SUPPRESS)
    ns = parser.parse_args()
    only = ns.only
    if only is not None:
        only = set(only.split(","))
        if not only <= {*phases, "vcddpm"}:
            parser.error(f"--only: unknown phases {sorted(only - {*phases, 'vcddpm'})}")
    run = lambda *names: only is None or bool(only & set(names))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (REPO / "t2v_torch" / "csrc").is_dir():
        print(f"chip_smoke: no t2v_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if ns.parallel_rank is not None:
        return _parallel_rank(ns.parallel_rank, ns.port, Path(ns.out))
    if ns.meshtrain_rank is not None:
        return _meshtrain_rank(ns.meshtrain_rank, ns.port, Path(ns.out))
    if ns.cli_args is not None:
        return _cli_rank(Path(ns.out), json.loads(ns.cli_args), not ns.cli_no_save)
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    build_kernels()
    records, launches = [], {}
    if run("kernels", "meshtrain"):
        check_mesh_gradients()
    if run("kernels"):
        records = check_kernels()
        print(f"kernel checks done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("small"):
        small = check_small_pipeline()
        if not all(small[k] for k in ("temporal_conv", "flash_attention", "fused_self_mha")):
            _fail(f"the small pipeline did not run every ModelScope kernel: {small}")
        small = check_small_vc_pipeline()
        if not all(small[k] for k in ("flash_attention", "fused_self_mha", "fused_cross_mha",
                                      "relpos_mha")):
            _fail(f"the small VideoCrafter pipeline did not run every kernel of its path: {small}")
        check_fp32_pipelines()
        print(f"small pipelines done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("train"):
        check_gradients()
        small = check_small_training()
        if not all(small[k] for k in ("temporal_conv", "flash_attention", "flash_bwd_dkv",
                                      "flash_bwd_dq", "fused_self_mha")):
            _fail(f"the small training step did not run every kernel of its path: {small}")
        print(f"gradient checks and small training step done at "
              f"{time.perf_counter() - t_start:.0f} s", flush=True)
    train = run("train")
    if run("modelscope", "train"):
        launches.update(drive_modelscope(run("modelscope"), train))
        print(f"ModelScope done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("generate"):
        launches.update(drive_generate())
        print(f"generate done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("modes"):
        by_name = {r.name: r for r in records}
        recs = {n: by_name.get(n) or KernelRecord(n, "", "", "") for n in
                ("fused_temporal_mha", "geglu")}
        launches.update(drive_modes(recs))
        print(f"ModelScope modes done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("videocrafter", "train"):
        launches.update(drive_videocrafter(run("videocrafter"), train))
        print(f"VideoCrafter done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("vcgenerate"):
        launches.update(drive_vcgenerate())
        print(f"vcgenerate done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("vcbranches"):
        launches.update(drive_vcbranches())
        print(f"vcbranches done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("parallel"):
        launches.update(drive_parallel())
        print(f"parallel done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if run("meshtrain"):
        launches.update(drive_meshtrain())
        print(f"meshtrain done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if only is not None and "vcddpm" in only:
        launches.update(drive_vcddpm())
        print(f"vcddpm done at {time.perf_counter() - t_start:.0f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if only is not None:
        print(f"chip_smoke --only {','.join(sorted(only))}: done; the full run prints the "
              "result line")
        return 0
    for rec in records:
        if not launches[rec.path][rec.counter]:
            _fail(f"{rec.name}: the {rec.path} path launched it no time")
    print(json.dumps({"kernels": [r.as_json(launches) for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
