"""The port's collective recorder (``t2v_torch/parallel/audit.py``) in one
process, without a process group: its ``Inventory`` against the JAX
package's on the same ops, ``param_full_shapes`` and
``assert_no_param_gather`` on hand-built ops, ``recording()`` off and on
around every collective of ``parallel/mesh.py`` and ``shared_seed`` with
``torch.distributed``'s calls stood in for by local ones, and
``site_census`` against what the tiny UNets record under such a stand-in
tp = 2 or sp = 2 axis, forward and backward. The two-rank and four-rank
groups hold the same model on real collectives
(``tests/test_torch_parallel.py``, ``tests/test_torch_mesh_train.py``).
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch import nn

from t2v.parallel import audit as jaudit
from t2v_torch.parallel import audit, multihost
from t2v_torch.parallel.mesh import Axis
from t2v_torch.parallel.sharding import parallel_unet
from _torch_ranks import FRAMES, seeded_unet, unet_inputs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OPS = [
    audit.CollectiveOp("all-reduce", "tp", "float32", ((2, 16, 32),), 4096, "forward"),
    audit.CollectiveOp("all-gather", "sp", "float32", ((2, 4, 8, 8, 32),), 65536, "forward"),
    audit.CollectiveOp("all-reduce", "sp", "float32", ((2, 16, 32),), 4096, "backward"),
    audit.CollectiveOp("all-reduce", "dp", "float32", ((1000,),), 4000, "gradient sum"),
    audit.CollectiveOp("all-gather", "tp", "bfloat16", ((64, 32),), 4096, audit.SAVE),
    audit.CollectiveOp("broadcast", "default", "int64", ((1,),), 8, "forward"),
]


def test_inventory_reads_as_the_jax_modules_does():
    """counts, total_bytes, gathered_shapes and summary of the same ops
    equal the JAX package's ``Inventory``'s (which parses them out of HLO);
    ``select``, ``tally`` and the JSON round trip."""
    jax_dtype = {"float32": "f32", "bfloat16": "bf16", "int64": "s64"}
    want = jaudit.Inventory([jaudit.CollectiveOp(op.kind, [(jax_dtype[op.dtype], s)
                                                           for s in op.shapes], op.bytes)
                             for op in OPS])
    inv = audit.Inventory(list(OPS))
    assert inv.counts == want.counts
    assert inv.total_bytes == want.total_bytes
    assert inv.gathered_shapes() == want.gathered_shapes() == {(2, 4, 8, 8, 32), (64, 32)}
    assert inv.summary() == want.summary()
    assert audit.Inventory().summary() == "no collectives"
    assert inv.select(axis="sp").ops == OPS[1:3]
    assert inv.select(phases=("forward",), kind="all-reduce").ops == OPS[:1]
    assert inv.tally()[("dp", "all-reduce", "gradient sum")] == [1, 4000]
    assert sum(c for c, _ in inv.tally().values()) == len(OPS)
    assert audit.Inventory.from_json(inv.to_json()) == inv


def test_param_full_shapes_and_the_param_gather_check():
    """Shapes of two or more dims, of a module or a flat dict; a gather of
    one fails the check outside the save phase only, an all-reduce of one
    (the dp gradient contract) never."""
    lin = nn.Linear(32, 64)
    assert audit.param_full_shapes(lin) == {(64, 32)}
    assert audit.param_full_shapes(dict(lin.named_parameters())) == {(64, 32)}
    full = audit.param_full_shapes(lin)
    audit.assert_no_param_gather(audit.Inventory(list(OPS)), full)  # its (64, 32) gather saves
    summed = dataclasses.replace(OPS[0], shapes=((64, 32),))
    audit.assert_no_param_gather(audit.Inventory([summed]), full)
    gathered = dataclasses.replace(OPS[4], phase="forward")
    with pytest.raises(AssertionError, match=r"rebuilds full parameter shapes \[\(64, 32\)\]"):
        audit.assert_no_param_gather(audit.Inventory([*OPS, gathered]), full)


@pytest.fixture
def local_collectives(monkeypatch):
    """``torch.distributed``'s collectives stood in for by local ones (a
    sum over one rank; every rank's piece this one's), and a group of two
    for ``shared_seed``."""
    def all_gather(parts, t, group=None):
        for p in parts:
            p.copy_(t)

    monkeypatch.setattr(dist, "all_reduce", lambda t, op=None, group=None: None)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "broadcast_object_list", lambda box, src=0: None)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)


def _collectives(axis: Axis) -> None:
    """One call of each collective of ``parallel/mesh.py`` and of
    ``shared_seed``, with the backward of the three autograd ones."""
    x = torch.randn(2, 3, 5, requires_grad=True)
    y = axis.all_reduce_sum(x.bfloat16(), backward="sum")
    y = y + axis.all_reduce_sum(x, backward="identity")
    y = y + axis.copy_in(x)
    axis.all_gather(y, dim=1).sum().backward()
    with audit.phase("gradient sum"):
        axis.all_reduce_buckets([x.detach(), torch.ones(7, dtype=torch.bfloat16)])
    multihost.shared_seed(5)


def test_recording_is_off_by_default_and_on_records_every_collective(local_collectives):
    axis = Axis(2, 0, None, "tp")
    assert audit.recorders == []
    _collectives(axis)  # nothing open: nothing recorded, nothing kept
    assert audit.recorders == []
    with audit.recording() as outer:
        with audit.recording() as inv:
            _collectives(axis)
        assert len(audit.recorders) == 1 and audit.recorders[0] is outer
    assert audit.recorders == []
    f32 = lambda *shape: ("float32", (shape,), 4 * torch.Size(shape).numel())
    want = [
        ("all-reduce", "tp", *f32(2, 3, 5), "forward"),      # the bf16 sum, in float32
        ("all-reduce", "tp", *f32(2, 3, 5), "forward"),
        ("all-gather", "tp", *f32(2, 6, 5), "forward"),      # the result
        ("all-reduce", "tp", *f32(2, 6, 5), "backward"),     # the gather's reduce-scatter
        ("all-reduce", "tp", *f32(2, 3, 5), "backward"),     # copy_in's
        ("all-reduce", "tp", *f32(2, 3, 5), "backward"),     # the "sum" backward's
        ("all-reduce", "tp", *f32(37), "gradient sum"),       # one float32 bucket of both
        ("broadcast", "default", "int64", ((1,),), 8, "forward"),
    ]
    assert [dataclasses.astuple(op) for op in inv.ops] == want
    assert outer.ops == inv.ops
    with pytest.raises(ValueError, match="phase is one of"):
        with audit.phase("warm-up"):
            pass


@pytest.mark.parametrize("family", ["ms", "vc"])
@pytest.mark.parametrize("kind", ["tp", "sp"])
def test_site_census_matches_what_the_unet_records(local_collectives, family, kind):
    """The tiny UNet under a stand-in tp = 2 or sp = 2 axis: one call
    without gradients, then one with its backward; each time every site
    ``installed_sites`` names is called once, and the census's tally is
    the recorded one, calls and bytes."""
    unet = seeded_unet(family)
    axis = Axis(2, 0, None, kind)
    x, t, ctx = (torch.from_numpy(a) for a in unet_inputs())
    x = axis.shard(x, 1) if kind == "sp" else x
    sites = audit.installed_sites(unet, 2 if kind == "tp" else 1, 2 if kind == "sp" else 1)
    assert sites
    for grad in (False, True):
        with torch.set_grad_enabled(grad), parallel_unet(unet, **{kind: axis}), \
                audit.recording() as inv, audit.site_census(unet) as census:
            out = unet(x, t, ctx)
            if grad:
                out.square().mean().backward()
        called = {k: v for k, v in census.site_calls.items() if k != "column-parallel"}
        assert called == dict(sites)
        assert inv.tally() == census.expected
        assert {op.phase for op in inv.ops} == ({"forward", "backward"} if grad else {"forward"})
        gathered = inv.select(kind="all-gather").gathered_shapes()
        assert all(s[1] == FRAMES for s in gathered)
        audit.assert_no_param_gather(inv, audit.param_full_shapes(unet))
