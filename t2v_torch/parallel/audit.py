"""The collectives a rank issues, recorded as it issues them, and the port's
communication model that they are held to.

The port of the JAX package's ``parallel/audit.py``. The JAX package lets
XLA insert the collectives of its mesh programs and reads them back out of
the compiled HLO; the port issues every collective itself
(``parallel/mesh.py``, ``multihost.shared_seed``), so each one records
itself while a ``recording()`` block is open: its kind, the mesh axis it
ran on, its dtype, shapes and bytes, and the phase of the work that issued
it. A change that sums, gathers or broadcasts more than the design says
passes every numeric test; its inventory does not:

  * tp keeps its parameters split: no all-gather has a full parameter's
    shape (``assert_no_param_gather``), outside the save phase, where the
    train state's pieces are gathered by design;
  * sp gathers only activations along the frame axis, every gathered shape
    carrying the full frame count there; its GroupNorm sums are
    2 x batch x groups floats;
  * a training step sums its gradients in one bucketed pass an axis.

Recording is off by default: a collective then pays one test of
``recorders``. On, it reads shapes only, with no host copy and no sync.

``site_census`` is the model's side: forward hooks on the modules whose
``tp`` or ``sp`` slot ``parallel_unet`` filled count each site's calls and
tally the collectives the design gives it (the ``Axis`` docstrings), from
the shapes the site sees, for a test to hold the recorded inventory to.
"""

from __future__ import annotations

import contextlib
import json
from collections import Counter
from dataclasses import asdict, dataclass, field

import torch
from torch import nn

PHASES = ("forward", "backward", "gradient sum", "save/restore")
SAVE = "save/restore"


@dataclass(frozen=True)
class CollectiveOp:
    kind: str                          # "all-reduce", "all-gather" or "broadcast"
    axis: str                          # "dp", "sp", "tp", or "default" (the whole group)
    dtype: str                         # e.g. "float32", "bfloat16"
    shapes: tuple[tuple[int, ...], ...]  # the result's (an all-gather) or the summed tensor's
    bytes: int                         # an all-gather counts its result's bytes
    phase: str                         # one of PHASES


@dataclass
class Inventory:
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def counts(self) -> Counter:
        return Counter(op.kind for op in self.ops)

    @property
    def total_bytes(self) -> Counter:
        c: Counter = Counter()
        for op in self.ops:
            c[op.kind] += op.bytes
        return c

    def gathered_shapes(self) -> set[tuple[int, ...]]:
        return {dims for op in self.ops if op.kind == "all-gather" for dims in op.shapes}

    def summary(self) -> str:
        parts = [f"{kind}: {n} ops / {self.total_bytes[kind]:,} B"
                 for kind, n in sorted(self.counts.items())]
        return "; ".join(parts) or "no collectives"

    def select(self, *, phases=PHASES, **fields) -> "Inventory":
        """The ops of the given phases whose other fields equal ``fields``."""
        return Inventory([op for op in self.ops if op.phase in phases
                          and all(getattr(op, k) == v for k, v in fields.items())])

    def tally(self) -> dict[tuple[str, str, str], list[int]]:
        """{(axis, kind, phase): [calls, bytes]}, the form ``Census.expected`` has."""
        out: dict = {}
        for op in self.ops:
            calls_bytes = out.setdefault((op.axis, op.kind, op.phase), [0, 0])
            calls_bytes[0] += 1
            calls_bytes[1] += op.bytes
        return out

    def to_json(self) -> str:
        return json.dumps([asdict(op) for op in self.ops])

    @classmethod
    def from_json(cls, text: str) -> "Inventory":
        return cls([CollectiveOp(**{**d, "shapes": tuple(tuple(s) for s in d["shapes"])})
                    for d in json.loads(text)])


# the open recordings (``recording``): a collective records itself into each
# of them, and does nothing more than test that this list is empty while none
# is open
recorders: list[Inventory] = []
_phase = ["forward"]


@contextlib.contextmanager
def recording():
    """An ``Inventory`` of every collective this process issues while the
    block is open (an enclosing recording gets them too)."""
    inv = Inventory()
    recorders.append(inv)
    try:
        yield inv
    finally:  # by identity: two recordings may hold equal ops
        del recorders[next(i for i, r in enumerate(recorders) if r is inv)]


@contextlib.contextmanager
def phase(name: str):
    """Record the collectives issued inside the block under ``name`` (the
    phase is "forward" outside any; a backward records "backward" itself)."""
    if name not in PHASES:
        raise ValueError(f"phase is one of {PHASES}, not {name!r}")
    _phase.append(name)
    try:
        yield
    finally:
        _phase.pop()


def _dtype(t: torch.dtype) -> str:
    return str(t).removeprefix("torch.")


def record(kind: str, axis: str, t: torch.Tensor, phase: str | None = None) -> None:
    """Add one op to every open recording: ``t`` is the tensor that the
    call sums or broadcasts, or the result of an all-gather."""
    op = CollectiveOp(kind, axis, _dtype(t.dtype), (tuple(t.shape),),
                      t.numel() * t.element_size(), phase or _phase[-1])
    for inv in recorders:
        inv.ops.append(op)


def param_full_shapes(params) -> set[tuple[int, ...]]:
    """The set of full (unsplit) parameter shapes of a module or a flat
    ``name -> tensor`` dict, of the leaves with two or more dims: what no
    all-gather may rebuild."""
    leaves = params.parameters() if isinstance(params, nn.Module) else params.values()
    return {tuple(t.shape) for t in leaves if t.dim() >= 2}


def assert_no_param_gather(inv: Inventory, full_param_shapes: set[tuple[int, ...]]) -> None:
    """Raise if an all-gather outside the save phase rebuilds a full
    parameter shape: a tp site that gathers its weight, which turns tp
    into every rank holding everything, every call."""
    bad = inv.select(phases=tuple(p for p in PHASES if p != SAVE)).gathered_shapes()
    bad &= full_param_shapes
    if bad:
        raise AssertionError(f"all-gather rebuilds full parameter shapes {sorted(bad)}: "
                             "a tp parameter should stay split")


# ---------------------------------------------------------------------------
# The model's side: the sites ``parallel_unet`` installs and what they issue


def installed_sites(unet: nn.Module, tp: int, sp: int) -> Counter:
    """The collective sites that ``parallel_unet`` installs in ``unet`` for
    a tp-way and sp-way split: "row-parallel" (every attention or
    feed-forward that tp splits: one float32 sum of its output a call),
    "temporal" (every module that mixes frames: one frame gather a call)
    and "group-norm" (every GroupNorm whose statistics span the frames:
    one sum of 2 x batch x groups floats a call)."""
    from t2v_torch.models.blocks import FrameGroupNorm32
    from t2v_torch.parallel.sharding import sp_modules, tp_modules

    sites: Counter = Counter()
    if tp > 1:
        sites["row-parallel"] = sum(1 for _ in tp_modules(unet, tp))
    if sp > 1:
        for mod in sp_modules(unet):
            sites["group-norm" if isinstance(mod, FrameGroupNorm32) else "temporal"] += 1
    return +sites


@dataclass
class Census:
    """What ``site_census`` counted: each site kind's calls, and the
    collectives the design gives them, as ``Inventory.tally`` reads."""

    site_calls: Counter = field(default_factory=Counter)
    expected: dict = field(default_factory=dict)

    def add(self, axis: str, kind: str, phase: str, nbytes: int) -> None:
        calls_bytes = self.expected.setdefault((axis, kind, phase), [0, 0])
        calls_bytes[0] += 1
        calls_bytes[1] += nbytes

    def to_json(self) -> str:
        return json.dumps({"site_calls": dict(self.site_calls),
                           "expected": [[*k, *v] for k, v in self.expected.items()]})

    @classmethod
    def from_json(cls, text: str) -> "Census":
        d = json.loads(text)
        return cls(Counter(d["site_calls"]), {tuple(e[:3]): e[3:] for e in d["expected"]})


def _grad(t) -> bool:
    return t is not None and torch.is_grad_enabled() and t.requires_grad


def _site_hook(census: Census):
    from t2v_torch.models.blocks import CrossAttention, FrameGroupNorm32

    def hook(mod, args, kwargs, out):
        x = args[0]
        tp, sp = getattr(mod, "tp", None), getattr(mod, "sp", None)
        grows = sp.size if sp is not None else 1  # a frame-mixing module runs on every frame
        if isinstance(mod, FrameGroupNorm32):
            if sp is not None:  # the float32 (sum, sum of squares) of each group
                census.site_calls["group-norm"] += 1
                nbytes = 2 * x.shape[0] * mod.num_groups * 4
                census.add(sp.name, "all-reduce", "forward", nbytes)
                if _grad(x):
                    census.add(sp.name, "all-reduce", "backward", nbytes)
            return
        if sp is not None:  # the frames gathered in; a reduce-scatter back
            census.site_calls["temporal"] += 1
            census.add(sp.name, "all-gather", "forward", grows * x.numel() * x.element_size())
            if _grad(x):
                census.add(sp.name, "all-reduce", "backward", grows * x.numel() * 4)
        if tp is not None:
            census.site_calls["row-parallel"] += 1
            census.add(tp.name, "all-reduce", "forward", grows * out.numel() * 4)
            inputs = [grows * x.numel()] if _grad(x) else []
            if isinstance(mod, CrossAttention):
                context = kwargs.get("context", args[1] if len(args) > 1 else None)
                if _grad(context):
                    inputs.append(context.numel())
            if getattr(mod, "use_relative_position", False):  # the whole rel-pos tables
                t = (kwargs.get("frame_split") or x.shape[1]) * grows
                for rel in (mod.relative_position_k, mod.relative_position_v):
                    if _grad(rel.embeddings_table):
                        inputs.append(t * t * mod.dim_head)
            for n in inputs:  # copy_in: the column-parallel inputs' gradients, summed
                census.site_calls["column-parallel"] += 1
                census.add(tp.name, "all-reduce", "backward", n * 4)

    return hook


@contextlib.contextmanager
def site_census(unet: nn.Module):
    """A ``Census`` of the sites of ``unet`` called while the block is open
    with their ``tp`` or ``sp`` slot filled, and the collectives the design
    gives each call: a row-parallel site one float32 all-reduce of its
    output over tp (its backward none), each column-parallel input that
    needs a gradient one over tp in the backward; a temporal site one
    all-gather of its frames over sp (the backward one float32 all-reduce
    of the gathered shape); a frame GroupNorm one all-reduce of its sums
    over sp, forward and backward. A frame-mixing module runs on sp times
    its input's frames."""
    census = Census()
    hook = _site_hook(census)
    handles = [mod.register_forward_hook(hook, with_kwargs=True) for mod in unet.modules()
               if hasattr(type(mod), "tp") or hasattr(type(mod), "sp")]
    try:
        yield census
    finally:
        for h in handles:
            h.remove()
