"""The Python glue of the port's redesigned kernels, on the CPU: the
per-shape plans that ``kernels/temporal_conv.py::layer_plan``,
``kernels/fused_mha.py::self_mha_plan``,
``kernels/flash_attention.py::flash_plan`` and ``::flash_bwd_plan`` hand
to the CUDA entries, at
every shape ``chip_smoke.py`` holds those kernels against their plain
versions, the folded GroupNorm of the temporal-conv activation pass, and
the chain's route through one layer on raw sums. No model, no JAX
compile: the file's tests take about a second.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from t2v_torch.kernels import flash_attention as tfa
from t2v_torch.kernels import fused_mha as tfm
from t2v_torch.kernels import temporal_conv as ttc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

MAX_SMEM = 232448
SMS = 132
INT32_MAX = 2**31 - 1

CONV_SHAPES = chip_smoke.CONV_SHAPES + chip_smoke.CONV_LONG_SHAPES
# (sequences, queries, keys, heads, head dim) of every launch of the packed
# kernel that chip_smoke.py checks: self-attention, frame-axis attention
# (one sequence per sample and token, of F rows) and cross-attention over
# a shared context (the 77-token text context included)
MHA_CASES = (
    [(b, n, n, h, d) for b, n, h, d in chip_smoke.SELF_MHA_CASES]
    + [(b * n, f, f, h, d) for b, f, n, h, d in chip_smoke.TEMPORAL_MHA_CASES]
    + [(b, n, s, h, d) for b, n, s, h, d in chip_smoke.CROSS_MHA_CASES]
)


def test_layer_plan_is_legal():
    for shape in CONV_SHAPES:
        _check_layer_plan(*shape)


def _check_layer_plan(b, f, hw, c):
    p = ttc.layer_plan(b, f, hw, c)
    m = f * hw
    assert (p.bm, p.bn) in ttc.TILES and 2 <= p.stages <= ttc.MAX_STAGES
    # shared memory: the ring, or the epilogue that reuses it, within a block's limit
    stage = p.bm * 64 * 2 + p.bn * 64 * 2
    epilogue = p.bm * p.bn * 2 + p.bm // 16 * p.bn * 8
    assert p.smem_bytes == max(p.stages * stage, epilogue) + ttc.SMEM_SLACK <= MAX_SMEM
    # the column tiles cover C exactly; a ragged last one is declared, and is
    # whole 64-wide boxes
    assert 0 < p.last_cols <= p.bn and p.last_cols % 64 == 0
    assert (p.col_tiles - 1) * p.bn + p.last_cols == c
    assert (p.last_cols < p.bn) == (c % p.bn != 0)
    # one partial-statistics row per row tile of a sample
    assert p.row_tiles == math.ceil(m / p.bm)
    assert p.blocks == b * p.row_tiles * p.col_tiles
    assert p.row_tiles <= 65535  # grid.y
    # TMA row coordinates m0 + (tap - 1) * HW and the byte strides of the
    # (C, F*HW, B) tensor map fit their fields at 250 frames
    assert -hw >= -INT32_MAX and (p.row_tiles - 1) * p.bm + hw + p.bm <= INT32_MAX
    assert m * c * 2 < 2**40 and m * c * 2 % 16 == 0
    # at least one block per SM wherever some tile gives that many
    most = max(b * math.ceil(m / bm) * math.ceil(c / bn) for bm, bn in ttc.TILES)
    assert p.blocks >= min(SMS, most)


def test_layer_plan_dominant_shapes():
    """The 24-frame top level runs 128 x 256 tiles on two consumer
    warpgroups, its C = 320 as a full column tile and a ragged one of 64;
    the smallest level, too small for 128-row tiles to fill the card, takes
    64-row ones."""
    p = ttc.layer_plan(2, 24, 1024, 320)
    assert (p.bm, p.bn, p.last_cols, p.col_tiles, p.row_tiles) == (128, 256, 64, 2, 192)
    assert ttc.layer_plan(2, 125, 1024, 320).row_tiles == 1000
    p = ttc.layer_plan(2, 24, 16, 1280)
    assert p.bm == 64 and p.blocks >= SMS


def test_self_mha_plan_is_legal():
    for case in MHA_CASES:
        _check_self_mha_plan(*case)


def _check_self_mha_plan(n_seq, n, s, heads, d):
    p = tfm.self_mha_plan(n_seq, n, s, heads, d)
    assert p.dp >= d and p.dp % 16 == 0 and p.dp - d < 16
    assert p.kc in (32, 64) and p.warps in (1, 2, 4, 8)
    n_chunks = math.ceil(s / p.kc)
    n_qt = math.ceil(n / tfm.QT)
    pairs = n_seq * heads
    # several pairs a block only when their whole K/V sits in shared memory
    assert p.pairs_per_block == 1 or (p.resident and n_chunks == 1)
    assert p.warps <= p.pairs_per_block * p.tiles_per_block
    row = (p.dp + 8) * 2
    nbuf = p.pairs_per_block * n_chunks if p.resident else 2
    assert p.smem_bytes == nbuf * 2 * p.kc * row + p.warps * tfm.QT * row <= MAX_SMEM
    # every query tile of every pair is owned by exactly one block
    qsplit = math.ceil(n_qt / p.tiles_per_block)
    assert (qsplit - 1) * p.tiles_per_block < n_qt <= qsplit * p.tiles_per_block
    assert p.blocks == math.ceil(pairs / p.pairs_per_block) * qsplit <= INT32_MAX
    # at least one block per SM wherever the (pair, query tile) items allow it
    assert p.blocks >= min(SMS, pairs * n_qt)
    assert len(p.ints()) == 5


def test_self_mha_plan_dominant_shapes():
    """The 16x16 spatial self-attention keeps each pair's K/V resident and
    reads it once; 24-frame temporal attention packs four pairs a block; a
    head dim of 160 over 450 keys streams its K/V."""
    p = tfm.self_mha_plan(48, 256, 256, 10, 64)
    assert (p.resident, p.pairs_per_block, p.tiles_per_block, p.warps) == (True, 1, 16, 8)
    p = tfm.self_mha_plan(2048, 24, 24, 5, 64)
    assert (p.resident, p.pairs_per_block, p.kc) == (True, 4, 32)
    assert not tfm.self_mha_plan(132, 450, 450, 2, 160).resident


def test_self_mha_plan_for_the_text_context():
    """VideoCrafter's cross-attention over the 77-token context: many query
    tiles over one resident K/V of three 32-row chunks (96 padded keys, not
    128), and at least two blocks for each SM."""
    p = tfm.self_mha_plan(2, 16384, 77, 8, 40)
    assert (p.resident, p.pairs_per_block, p.kc, p.dp) == (True, 1, 32, 48)
    assert p.blocks >= 2 * SMS and p.tiles_per_block >= 16


def test_flash_plan_is_legal():
    """The forward's plan at every shape ``chip_smoke.py`` checks: the tile
    shape of the head dim, a ring within shared memory, and one block per
    (batch*head, query tile)."""
    for b, n, s, d, _ in chip_smoke.FLASH_CASES:
        p = tfa.flash_plan(b, n, s, d)
        boxes = math.ceil(d / 64)
        assert p.column_split == (d == 512) and p.bq == (64 if d == 512 else 128)
        assert p.bkv in ((64, 128) if d <= 64 else (64,))
        assert 1 <= p.stages <= min(tfa.MAX_STAGES, math.ceil(s / p.bkv))
        assert p.smem_bytes == (boxes * (p.bq + 2 * p.stages * p.bkv) * 128
                                + tfa.SMEM_SLACK) <= MAX_SMEM
        assert p.blocks == b * math.ceil(n / p.bq) and b <= 65535  # grid (query tiles, B)
        # the TMA maps' row stride is a multiple of 16 bytes
        assert d * 2 % 16 == 0
        # O's f32 registers a consumer thread holds: 64 rows x the columns
        # its warpgroup owns, over 128 threads
        cols = 64 * boxes // (2 if p.column_split else 1)
        assert 64 * cols // 128 <= 128
    # the dominant shape: 128 x 128 tiles, two or more stages in flight
    p = tfa.flash_plan(240, 1024, 1024, 64)
    assert (p.bq, p.bkv, p.blocks) == (128, 128, 240 * 8) and p.stages >= 2


def test_flash_bwd_plan_is_legal():
    """The backward's plan at every shape ``chip_smoke.py`` checks: the
    tiles of the head dim, both rings within shared memory, the f32 tiles a
    consumer thread holds within its registers, one block per (batch*head,
    key tile) for dkv and per (batch*head, query tile) for dq, and the TMA
    maps' 16-byte strides; then the plan at the two training-path shapes."""
    for b, n, s, d, _ in chip_smoke.FLASH_BWD_CASES:
        p = tfa.flash_bwd_plan(b, n, s, d)
        boxes = math.ceil(d / 64)
        # dkv: 128-key blocks, two warpgroups of 64 keys, up to d = 64; 64-key
        # blocks whose warpgroups split dV and dK above; 64-query tiles.
        # dq: 128 query rows over 64-key tiles
        assert p.split == (d > 64) and p.dkv_bkv == (64 if p.split else 128)
        assert (p.dkv_bq, p.dq_bq, p.dq_bkv) == (tfa.DKV_BQ, tfa.DQ_BQ, tfa.DQ_BKV) == (64, 128, 64)
        assert 1 <= p.dkv_stages <= min(tfa.MAX_STAGES, math.ceil(n / p.dkv_bq))
        assert 1 <= p.dq_stages <= min(tfa.MAX_STAGES, math.ceil(s / p.dq_bkv))
        # shared memory: the resident tiles and the ring (dkv's stages carry
        # 64 lse and 64 delta values in f32 beside the Q and dO tiles)
        assert p.dkv_smem_bytes == (boxes * (2 * p.dkv_bkv + 2 * p.dkv_stages * p.dkv_bq) * 128
                                    + 2 * p.dkv_stages * p.dkv_bq * 4
                                    + tfa.SMEM_SLACK) <= MAX_SMEM
        assert p.dq_smem_bytes == (boxes * (2 * p.dq_bq + 2 * p.dq_stages * p.dq_bkv) * 128
                                   + tfa.SMEM_SLACK) <= MAX_SMEM
        # f32 registers a consumer thread holds: 64-row tiles over 128
        # threads. dkv: S^T and dP^T (64 x 64 queries) and dK and dV (64 x
        # the padded head dim), only one of the two in the split; dq: S and
        # dP (64 x 64 keys) and dQ. Within 128 of the 168 a thread gets,
        # the rest for addresses and the bf16 fragments, up to d = 80; at
        # d = 160 160, which ptxas spills a little (PERF.md)
        tile = lambda cols: 64 * cols // 128  # noqa: E731
        grads = 1 if p.split else 2
        dkv_regs = 2 * tile(p.dkv_bq) + grads * tile(64 * boxes)
        dq_regs = 2 * tile(p.dq_bkv) + tile(64 * boxes)
        assert max(dkv_regs, dq_regs) <= (128 if d <= 80 else 160)
        # one block per (batch*head, tile), B on grid.y
        assert p.dkv_blocks == b * math.ceil(s / p.dkv_bkv)
        assert p.dq_blocks == b * math.ceil(n / p.dq_bq)
        assert b <= 65535
        # the TMA maps' row stride is a multiple of 16 bytes
        assert d * 2 % 16 == 0
    # the path shapes: ModelScope's 80 heads of 64 and VideoCrafter's 128 of
    # 40 at 1024 tokens, both unsplit with full rings, 8 key tiles and 8
    # query tiles a head
    for (b, n, s, d, _), blocks in zip(chip_smoke.FLASH_BWD_PATH, (640, 1024)):
        p = tfa.flash_bwd_plan(b, n, s, d)
        assert (p.dkv_bkv, p.split, p.dkv_stages, p.dkv_blocks) == (128, False, 4, blocks)
        assert (p.dq_stages, p.dq_blocks) == (4, blocks)


def test_plan_constants_match_the_cuda_sources():
    tc_src = (REPO / "t2v_torch" / "csrc" / "temporal_conv.cu").read_text()
    mha_src = (REPO / "t2v_torch" / "csrc" / "fused_mha.cu").read_text()
    fa_src = (REPO / "t2v_torch" / "csrc" / "flash_attention.cu").read_text()
    for name, value in (("MAX_SMEM", tfa.MAX_SMEM), ("MAX_STAGES", tfa.MAX_STAGES),
                        ("SMEM_SLACK", tfa.SMEM_SLACK)):
        assert re.search(rf"constexpr int {name} = {value};", fa_src), name
    for name, value in (("BK", ttc.BK), ("MAX_SMEM", ttc.MAX_SMEM),
                        ("SMEM_SLACK", ttc.SMEM_SLACK)):
        assert re.search(rf"constexpr int {name} = {value};", tc_src), name
    assert re.search(rf"constexpr int QT = {tfm.QT};", mha_src)
    assert re.search(rf"constexpr int MAX_SMEM = {tfm.MAX_SMEM};", mha_src)
    for bm, bn in ttc.TILES:
        assert f"T2V_GEMM({bm}, {bn})" in tc_src
    bwd_src = (REPO / "t2v_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    for name, value in (("MAX_SMEM", tfa.MAX_SMEM), ("MAX_STAGES", tfa.MAX_STAGES),
                        ("SMEM_SLACK", tfa.SMEM_SLACK), ("DKV_BQ", tfa.DKV_BQ),
                        ("DQ_BQ", tfa.DQ_BQ), ("DQ_BKV", tfa.DQ_BKV)):
        assert re.search(rf"constexpr int {name} = {value};", bwd_src), name
    # the dkv split: 64-key tiles from two 64-column boxes (d > 64) on
    assert "SPLIT = NB > 1;" in bwd_src and "DKV_BKV = SPLIT ? 64 : 128;" in bwd_src
    for d in tfa.BWD_SUPPORTED_D:
        assert f"T2V_DKV({d})" in bwd_src and f"T2V_DQ({d})" in bwd_src


@pytest.mark.parametrize("mean", [0.0, 8.0])
def test_folded_norm_reproduces_the_layer_activation(mean):
    """The activation pass's prologue (``csrc/temporal_conv.cu``,
    ``temporal_conv_act_kernel``) folds GroupNorm into one scale and shift
    a channel, ``a = inv * scale``, ``b = bias - mu * a``, from either the
    finalised statistics or, inside the chain, the raw sums finalised as
    ``finalize_stats`` does. silu(x * a + b) against the activation of
    ``_layer_math`` (GroupNorm in the JAX order, affine, SiLU), in f32
    before the bf16 rounding both apply; inputs far from zero mean too,
    where the shift cancels most of x * a."""
    rng = np.random.default_rng(7)
    b, f, hw, c = 2, 3, 5, 64
    x = torch.from_numpy((mean + rng.normal(size=(b, f, hw, c))).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=(c,))).astype(np.float32))
    raw = ttc.input_stats(x)
    fin = ttc.finalize_stats(raw, f * hw, 1e-5)
    want = F.silu((x - fin[:, 0, None, None]) * fin[:, 1, None, None] * scale + bias)
    # the raw-sum route: group sums over C / 32 channels of F * HW values each
    gs = c // ttc.NUM_GROUPS
    g = raw.reshape(b, 2, ttc.NUM_GROUPS, gs).sum(-1)
    mu = g[:, 0] / (f * hw * gs)
    inv = torch.rsqrt(g[:, 1] / (f * hw * gs) - mu * mu + 1e-5)
    for mu_c, inv_c in ((fin[:, 0], fin[:, 1]),
                        (mu.repeat_interleave(gs, -1), inv.repeat_interleave(gs, -1))):
        a = inv_c * scale
        shift = bias - mu_c * a
        got = F.silu(x * a[:, None, None] + shift[:, None, None])
        # f32 rounding of |x * a| (up to about 1 + |mean| / sigma) on O(1) outputs
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * (1 + mean))


def test_layer_on_raw_sums_finalises_them():
    """The chain's route through one layer, the raw [sum; sum^2] of its
    input with ``raw_eps``, is the layer on the finalised statistics (on the
    CPU the wrapper finalises them in torch; on the card the activation
    pass does)."""
    rng = np.random.default_rng(3)
    b, f, hw, c = 1, 4, 6, 64
    x = torch.from_numpy(rng.normal(size=(b, f, hw, c)).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=(c,))).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, c, c)) / 14).astype(np.float32))
    cb = torch.from_numpy((0.1 * rng.normal(size=(c,))).astype(np.float32))
    raw = ttc.input_stats(x)
    got, got_stats = ttc.temporal_conv_layer(x, raw, scale, bias, w, cb, raw_eps=1e-5)
    want, want_stats = ttc.layer_plain(x, ttc.finalize_stats(raw, f * hw, 1e-5), scale, bias,
                                       w, cb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_stats, want_stats, rtol=0, atol=0)
