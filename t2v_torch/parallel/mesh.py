"""The process mesh of sharded sampling: dp x sp x tp groups of ranks.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with the axes
("dp", "sp", "tp") and lets XLA insert the collectives. The port keeps the
same axis order over ``torch.distributed`` ranks: rank ``(d·sp + s)·tp + t``
sits at (d, s, t), so tp groups are runs of consecutive ranks. Each axis of
a rank is an ``Axis``: its size, the rank's index on it, its process group,
and the collectives the sharded paths call explicitly:

  * ``all_reduce_sum``: float32 sums (tp's row-parallel products, the
    GroupNorm statistics of frames split over sp);
  * ``all_gather``: the pieces of a tensor along one axis, in index order
    (frames gathered under sp);
  * ``ProcessMesh.gather_samples``: the finished latents of every dp index
    to rank 0.

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

AXES = ("dp", "sp", "tp")


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from one rank."""

    size: int
    index: int
    group: object  # torch.distributed ProcessGroup

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the axis, as a new float32
        tensor."""
        buf = t.float().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (all of one shape), concatenated along
        ``dim`` in axis order."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim)

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's equal piece of ``t`` along ``dim``."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)


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
                    self.axes[name] = Axis(self.shape[name], coords[name], group)

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
