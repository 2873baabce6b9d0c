"""The process mesh of sharded sampling: dp x sp x tp groups of ranks.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with the axes
("dp", "sp", "tp") and lets XLA insert the collectives. The port keeps the
same axis order over ``torch.distributed`` ranks: rank ``(d·sp + s)·tp + t``
sits at (d, s, t), so tp groups are runs of consecutive ranks. Each axis of
a rank is an ``Axis``: its size, the rank's index on it, its process group,
and the collectives the sharded paths call explicitly:

  * ``all_reduce_sum``: float32 sums (tp's row-parallel products, the
    GroupNorm statistics of frames split over sp);
  * ``copy_in``: the identity, at the input of tp's column-parallel
    products;
  * ``all_gather``: the pieces of a tensor along one axis, in index order
    (frames gathered under sp);
  * ``all_reduce_buckets``: float32 sums of many tensors in a few large
    calls (the training step's gradients over dp and sp);
  * ``ProcessMesh.gather_samples``: the finished latents of every dp index
    to rank 0.

Every collective records itself while ``parallel/audit.py`` records (its
kind, this axis's name, dtype, shapes and bytes, and the phase), and pays
one test of a flag while it does not.

The first three are ``torch.autograd.Function``s whose backward is the one
the training step needs (Megatron's f and g for tp). Each rank
differentiates its own term of the global loss, and the backward must give
it the gradient of the whole loss with respect to its own tensors:

  * ``all_reduce_sum(x, backward="identity")``: the sum is replicated and
    every rank goes on with the same function of it (tp's row-parallel
    output, whose loss every tp rank computes alike), so the gradient of
    the sum is already the gradient of each partial (g);
  * ``all_reduce_sum(x, backward="sum")``: every rank's own loss term
    depends on the sum (sp's GroupNorm sums, each rank normalising its own
    frames), so a partial's gradient is the sum of every rank's;
  * ``copy_in(x)``: x is replicated and each rank uses it for its own
    slice of a product, so its gradient is the sum over the axis (f);
  * ``all_gather(x, dim)``: every rank computes on all the pieces and
    keeps its own part of the result, so a piece's gradient is the sum of
    every rank's gradient of that piece (a reduce-scatter, done as an
    all-reduce and a slice, which gloo has).

Every collective takes the tensors where they lie. An NCCL group works on
the cards; a gloo group (ranks sharing a card, or CPU ranks) stages CUDA
tensors through host memory itself: the card's torch build takes CUDA
tensors in gloo's all_reduce, broadcast and all_gather
(``chip_smoke.py --only parallel`` prints it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from t2v_torch.parallel import audit

AXES = ("dp", "sp", "tp")
# the most bytes of float32 that one call of ``Axis.all_reduce_buckets`` sums
BUCKET_BYTES = 256 << 20


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from one rank."""

    size: int
    index: int
    group: object  # torch.distributed ProcessGroup
    name: str      # "dp", "sp" or "tp": the axis its collectives are recorded under

    def all_reduce_sum(self, t: torch.Tensor, backward: str) -> torch.Tensor:
        """The elementwise sum of ``t`` over the axis, as a new float32
        tensor. ``backward`` is "identity" where every rank goes on with
        the same function of the sum, "sum" where each rank's own loss
        term depends on it (the module docstring)."""
        if backward not in ("identity", "sum"):
            raise ValueError(f"all_reduce_sum: backward is 'identity' or 'sum', not {backward!r}")
        return _AllReduceSum.apply(t, self, backward == "sum")

    def copy_in(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself, whose gradient is summed over the axis: a
        replicated input of a product split over the axis."""
        return _CopyIn.apply(t, self)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape), concatenated along
        ``dim`` in axis order; its gradient is every rank's gradient of
        this rank's piece, summed."""
        return _AllGather.apply(t, self, dim)

    def all_reduce_buckets(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise sums over the axis of ``tensors`` (of any
        dtypes and shapes, the same list on every rank), each returned in
        its own dtype. The tensors are packed into float32 buckets of at
        most ``BUCKET_BYTES`` (a tensor larger than that is one bucket),
        one all-reduce a bucket, and summed in float32."""
        out: list[torch.Tensor | None] = [None] * len(tensors)
        bucket: list[int] = []
        filled = 0

        def flush():
            if not bucket:
                return
            flat = torch.cat([tensors[i].detach().reshape(-1).float() for i in bucket])
            _all_reduce(flat, self)
            for i, piece in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
                out[i] = piece.view(tensors[i].shape).to(tensors[i].dtype)
            bucket.clear()

        for i, t in enumerate(tensors):
            if bucket and filled + 4 * t.numel() > BUCKET_BYTES:
                flush()
                filled = 0
            bucket.append(i)
            filled += 4 * t.numel()
        flush()
        return out

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's equal piece of ``t`` along ``dim``."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


def _all_reduce(buf: torch.Tensor, axis: Axis, phase: str | None = None) -> None:
    """Sum ``buf`` over ``axis`` in place."""
    if audit.recorders:
        audit.record("all-reduce", axis.name, buf, phase)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis: Axis, sum_grad: bool):
        ctx.axis, ctx.sum_grad, ctx.dtype = axis, sum_grad, t.dtype
        buf = t.float().clone()
        _all_reduce(buf, axis)
        return buf

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = g.float().clone()
            _all_reduce(g, ctx.axis, "backward")
        return g.to(ctx.dtype), None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis: Axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        buf = g.float().clone()
        _all_reduce(buf, ctx.axis, "backward")
        return buf.to(g.dtype), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis: Axis, dim: int):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        out = torch.cat(parts, dim=dim)
        if audit.recorders:  # the result's shape and bytes
            audit.record("all-gather", axis.name, out)
        return out

    @staticmethod
    def backward(ctx, g):
        buf = g.to(torch.float32, copy=True).contiguous()  # never the incoming gradient
        _all_reduce(buf, ctx.axis, "backward")
        piece = buf.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n).to(g.dtype).contiguous()
        return piece, None, None


class ProcessMesh:
    """dp x sp x tp groups over the first dp·sp·tp ranks of the default
    process group. Every rank of the group must build the same meshes in
    the same order (``new_group`` is collective); a rank past dp·sp·tp
    builds them too and has ``in_mesh`` False."""

    def __init__(self, dp: int = 1, sp: int = 1, tp: int = 1):
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.size = dp * sp * tp
        world = dist.get_world_size()
        if world < self.size:
            raise ValueError(f"a dp={dp} x sp={sp} x tp={tp} mesh needs {self.size} ranks; "
                             f"the process group has {world}")
        rank = dist.get_rank()
        self.in_mesh = rank < self.size
        coords = {"dp": rank // (sp * tp), "sp": rank // tp % sp, "tp": rank % tp}
        at = lambda d, s, t: (d * sp + s) * tp + t
        members = {
            "dp": [[at(d, s, t) for d in range(dp)] for s in range(sp) for t in range(tp)],
            "sp": [[at(d, s, t) for s in range(sp)] for d in range(dp) for t in range(tp)],
            "tp": [[at(d, s, t) for t in range(tp)] for d in range(dp) for s in range(sp)],
        }
        self.axes: dict[str, Axis | None] = dict.fromkeys(AXES)
        for name in AXES:
            for ranks in members[name]:
                group = dist.new_group(ranks)
                if rank in ranks:
                    self.axes[name] = Axis(self.shape[name], coords[name], group, name)

    @property
    def dp(self) -> Axis:
        return self.axes["dp"]

    @property
    def sp(self) -> Axis:
        return self.axes["sp"]

    @property
    def tp(self) -> Axis:
        return self.axes["tp"]

    def gather_samples(self, x: torch.Tensor, counts: list[int]) -> torch.Tensor | None:
        """The finished (count, F, ...) latents of every dp index, in sample
        order, on rank 0; None on the other ranks. ``counts`` gives each dp
        index's sample count; the frames are whole (gathered over sp
        before)."""
        most = max(counts)
        pad = x.new_zeros((most - x.shape[0], *x.shape[1:]))
        rows = self.dp.all_gather(torch.cat([x, pad])[None], dim=0)
        if dist.get_rank() != 0:
            return None
        return torch.cat([rows[d, :c] for d, c in enumerate(counts)])


# meshes by (dp, sp, tp): built once a process group, as every rank builds
# them in the same order; ``multihost.shutdown`` forgets them
_MESHES: dict[tuple[int, int, int], ProcessMesh] = {}


def get_mesh(dp: int = 1, sp: int = 1, tp: int = 1) -> ProcessMesh:
    """The cached dp x sp x tp mesh of the default process group."""
    key = (dp, sp, tp)
    if key not in _MESHES:
        _MESHES[key] = ProcessMesh(dp, sp, tp)
    return _MESHES[key]


def forget_meshes() -> None:
    _MESHES.clear()
