"""``benchmark/work``: the operation and byte counts against hand counts and
against the reference's own matrix products counted on the meta device."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import layers as L
from benchmark.reference import modelscope, videocrafter
from benchmark.reference.ops import Ops
from benchmark.work import layers as work


def _count(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def _meta(shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes}


def test_self_attention_hand_count():
    # 2 rows x 16 tokens of width 32, 2 heads of 16: q/k/v 3 x 2·32·32·32,
    # scores and P·V 2 x 2·(2·2)·16·16·16, output 2·32·32·32
    w = work.attention(2, 16, 32, 2, 16)
    assert w.flops == 3 * 65536 + 2 * 32768 + 65536
    # x in and out (2·32·32 elements), q/k/v/out weights and the out bias
    assert w.bytes == 2 * (2 * 32 * 32 + 4 * 32 * 32 + 32)
    sd = _meta(L.attention_shapes("a", 32, None, 32))
    x = torch.empty(2, 16, 32, device="meta")
    assert _count(lambda: L.attention(Ops(), sd, "a", x, 2)) == w.flops


def test_cross_and_temporal_attention_against_reference():
    sd = _meta(L.attention_shapes("a", 32, 48, 32))
    x, ctx = torch.empty(6, 16, 32, device="meta"), torch.empty(2, 7, 48, device="meta")
    w = work.attention(6, 16, 32, 2, 16, ctx_rows=2, s=7, dc=48)
    assert w.flops == 2 * 96 * 32 * 32 + 2 * 2 * 14 * 48 * 32 + 4 * 96 * 7 * 32 + 2 * 96 * 32 * 32
    # k and v are projected once per context row, then shared by its 3 rows
    assert _count(lambda: L.attention(Ops(), sd, "a", x, 2, ctx)) == w.flops
    cfg = {"use_relative_position": True, "temporal_length": 4}
    sd = _meta(videocrafter._temporal_attn_shapes("t", 32, 2, 16, cfg))
    x = torch.empty(2 * 4, 9, 32, device="meta")  # B·T rows of 9 tokens, T = 4
    w = work.attention(8, 9, 32, 2, 16, frames=4)
    assert w.flops == 4 * 2 * 72 * 32 * 32 + 8 * 72 * 4 * 32
    assert _count(lambda: videocrafter._temporal_attn(Ops(), sd, "t", x, 2, 4, cfg)) == w.flops


def test_temporal_conv_hand_count():
    # four layers of 3 taps of a 64 x 64 matrix over 1·4·8 tokens
    w = work.temporal_conv(1, 4, 8, 64)
    assert w.flops == 4 * 2 * 3 * 64 * 64 * 32
    assert w.bytes == 2 * (2 * 32 * 64 + 4 * (3 * 64 * 64 + 3 * 64))
    shapes = [s for i, slot in ((1, 2), (2, 3), (3, 3), (4, 3))
              for s in (*L.norm_shapes(f"c.conv{i}.0", 64), *L.conv_shapes(f"c.conv{i}.{slot}", 64, 64, (3, 1, 1)))]
    sd = _meta(shapes)
    x = torch.empty(1, 4, 2, 4, 64, device="meta")
    assert _count(lambda: modelscope._temporal_conv(Ops(), sd, "c", x)) == w.flops


def test_least_time():
    w = work.Work(flops=989e9, bytes=3.35e9)
    assert w.least_s({"flops": 989e12, "bytes_per_s": 3.35e12}) == 1e-3
    assert work.Work(1.0, 6.7e9).least_s({"flops": 989e12, "bytes_per_s": 3.35e12}) == 2e-3


def test_temporal_conv_work_counts_every_frame_under_a_split():
    """A temporal block whose frames are split over sp ranks gathers them:
    its work is over every frame."""
    from types import SimpleNamespace

    from benchmark.loops.request import _temporal_conv_work

    x = torch.empty(2, 6, 4, 4, 64, dtype=torch.bfloat16)
    whole = _temporal_conv_work(SimpleNamespace(sp=None), (x,), {})
    split = _temporal_conv_work(SimpleNamespace(sp=SimpleNamespace(size=4)), (x,), {})
    assert whole.flops == work.temporal_conv(2, 6, 16, 64).flops
    assert split.flops == work.temporal_conv(2, 24, 16, 64).flops
