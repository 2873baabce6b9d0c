"""One rank of the four-rank gloo group of ``tests/test_torch_mesh_train.py``.

    python tests/_torch_mesh_ranks.py RANK WORLD PORT OUT_DIR

Each rank joins the group over TCP on 127.0.0.1:PORT (float32, the CPU, one
torch thread), builds every mesh of ``MESHES`` (all ranks, in one order, as
``new_group`` asks), reads the global ``(t, noise)`` draw that the test
module wrote to OUT_DIR/draw.npz (the JAX step's own, recomputed from its
key), and runs, in this order:

  * every case of ``CASES`` (ModelScope full and LoRA, VideoCrafter full,
    each at dp = 2, tp = 2 and sp = 2 on ranks 0 and 1, and at sp = 2 x
    tp = 2 on all four): one ``loss_and_grads`` on this rank's share of
    ``batch()``, the gradients gathered to full tensors, then
    ``apply_gradients`` and the parameters gathered. A rank outside a
    case's mesh goes on to the next;
  * the VideoCrafter sp case again with a planted fault (the sp GroupNorm
    sums' backward taken as the identity, as an all-reduce that autograd
    does not see gives), and the sp x tp case with ``remat=True``;
  * the ModelScope full case at tp = 2 again with a planted fault that only
    the collectives show (``gather_fault``: one row-parallel site gathers
    its full weight at every call and drops it);
  * at sp = 2 x tp = 2, the train state of the ModelScope full case (its
    AdamW moments and EMA shadow after one step) saved and restored into a
    fresh state, and every parameter of both tiny UNets cut to its tp
    pieces and gathered back;
  * where OUT_DIR/data holds clips (written when cv2 is there),
    ``cli.train --tiny --device cpu`` over each mesh of ``CLI_MESHES`` for
    two steps, then ``--resume`` to a third, recording every step's loss.

Every case's step (``loss_and_grads``, the test's gathers of its gradients
and parameters, ``apply_gradients``) and the save and the restore are
recorded (``parallel/audit.py``), and every rank writes its inventories to
OUT_DIR/audit{RANK}.json. Rank 0 saves the results to OUT_DIR/cases.pt and
OUT_DIR/checks.json. The test module imports the builders below to make the
same weights and inputs.
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from _torch_ranks import seeded_unet  # noqa: E402
from t2v_torch.core.config import ModelScopeUNetConfig  # noqa: E402
from t2v_torch.diffusion.schedules import DiffusionSchedule  # noqa: E402
from t2v_torch.pipeline import lora as L  # noqa: E402

WORLD = 4
BATCH, FRAMES, LORA_RANK, ALPHA, LR = 2, 4, 2, 1.5, 1e-3
# mesh name -> its shape; the first three use ranks 0 and 1
MESHES = {"dp": {"dp": 2}, "tp": {"tp": 2}, "sp": {"sp": 2}, "sp_tp": {"sp": 2, "tp": 2}}
# (case name, family, "full" | "lora", mesh name)
CASES = [(f"{fam}_{kind}_{mesh}", fam, kind, mesh)
         for fam, kind in (("ms", "full"), ("ms", "lora"), ("vc", "full"))
         for mesh in MESHES]
CLI_ARGS = ["--tiny", "--device", "cpu", "--frames", "4", "--resolution", "32",
            "--log-every", "1", "--save-every", "2", "--ema-decay", "0.99"]
# the trainer's mesh flags over the four ranks (dp = ranks // (sp x tp)), and
# the batch size of each run
CLI_MESHES = {"sp2_tp2": (["--sp", "2", "--tp", "2"], 1), "dp2_tp2": (["--tp", "2"], 2)}
CLI_CLIPS = 2


def batch() -> dict:
    """The global batch (numpy): latents (2, 4, 8, 8, 4), context (2, 77, 32)."""
    rng = np.random.default_rng(21)
    return {"latents": rng.normal(size=(BATCH, FRAMES, 8, 8, 4)).astype(np.float32),
            "context": rng.normal(size=(BATCH, 77, 32)).astype(np.float32)}


def lora_tree(unet) -> dict:
    """A rank-2 LoRA tree (numpy, the JAX layout) over every linear of the
    tiny ModelScope UNet, with signal in A and B."""
    rng = np.random.default_rng(22)
    sd = unet.state_dict()
    tree = {}
    for name, (pname, kind) in L.unet_module_index(ModelScopeUNetConfig().tiny()).items():
        if kind == "linear" and sd[pname].dim() == 2:
            d_out, d_in = sd[pname].shape
            tree[name] = {"lora_A": (0.3 * rng.normal(size=(d_in, LORA_RANK))).astype(np.float32),
                          "lora_B": (0.05 * rng.normal(size=(LORA_RANK, d_out))).astype(np.float32)}
    return tree


def cli_argv(data: Path, out: Path, mesh: str, grouped: bool = True) -> list[str]:
    """The trainer's arguments of the ``CLI_MESHES`` run ``mesh``; without
    its mesh flags unless ``grouped`` (the one-process run)."""
    flags, batch_size = CLI_MESHES[mesh]
    argv = ["--data-dir", str(data), "--out", str(out), *CLI_ARGS,
            "--batch-size", str(batch_size)]
    return [*argv, *flags] if grouped else argv


@contextlib.contextmanager
def recorded_losses():
    """Every loss that a ``TrainStep`` call reports while the block is
    open, in order."""
    from t2v_torch.parallel import train as T

    losses, call = [], T.TrainStep.__call__

    def recording(self, *args, **kwargs):
        state, loss = call(self, *args, **kwargs)
        losses.append(float(loss))
        return state, loss

    T.TrainStep.__call__ = recording
    try:
        yield losses
    finally:
        T.TrainStep.__call__ = call


def _step(unet, kind, mesh, layout, *, remat=False, ema=None):
    """(state, step) of one case over ``mesh``."""
    from t2v_torch.parallel import train as T

    sched = DiffusionSchedule.linear_sd(1000)
    opt = T.make_optimizer(LR)
    apply_fn = T.module_apply_fn(unet, mesh)
    if kind == "full":
        state = T.init_train_state(dict(unet.named_parameters()), opt, mesh,
                                   with_ema=ema is not None, layout=layout)
        return state, T.make_train_step(apply_fn, sched, mesh, remat=remat, ema_decay=ema)
    lora = {n: {k: torch.tensor(v) for k, v in ab.items()} for n, ab in lora_tree(unet).items()}
    state = T.init_train_state(lora, opt, mesh)
    index = L.unet_module_index(ModelScopeUNetConfig().tiny())
    return state, T.make_lora_train_step(apply_fn, sched, dict(unet.named_parameters()), index,
                                         mesh, alpha=ALPHA, layout=layout)


@contextlib.contextmanager
def gather_fault(unet, layout: dict, tp):
    """While the block is open, the first row-parallel attention of
    ``unet`` also gathers its full out-projection weight from its tp pieces
    (``sharding.gather_tensor``) at every call, and drops it: the
    arithmetic is unchanged, only the traffic grows."""
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


def run_case(unet, kind, mesh, draw, fault: bool = False, **kw) -> dict | None:
    """The loss, the gathered gradients, and the gathered parameters after
    the optimizer step, of one case on this rank (None outside ``mesh``),
    and what it recorded (``audit``: its collectives and the census of the
    UNet's sites, as JSON). ``fault`` plants ``gather_fault`` in the step."""
    from t2v_torch.parallel import audit
    from t2v_torch.parallel import train as T
    from t2v_torch.parallel.sharding import gather_params, tp_layout

    if not mesh.in_mesh:
        return None
    layout = tp_layout(unet, mesh.tp.size)
    state, step = _step(unet, kind, mesh, layout, **kw)
    glob = {k: torch.from_numpy(v) for k, v in batch().items()}
    with audit.recording() as inv, audit.site_census(unet) as census:
        with gather_fault(unet, layout, mesh.tp) if fault else contextlib.nullcontext():
            loss, grads = step.loss_and_grads(state, T.local_batch(mesh, glob), None, draw)
        names = [n for n, _ in T.tree_items(state.params)]
        out = {"loss": float(loss),
               "grads": gather_params(dict(zip(names, grads)), layout, mesh.tp)}
        step.apply_gradients(state, grads)
        out["params"] = gather_params(dict(T.tree_items(state.params)), layout, mesh.tp)
    out["audit"] = {"ops": inv.to_json(), "census": census.to_json()}
    return out


def _state_round_trip(unet, mesh, draw, out: Path) -> tuple[bool, dict]:
    """A sharded full state after one step with an EMA, saved (every rank
    calls it, rank 0 writes) and restored into a fresh state: whether every
    piece of it came back exactly, and the collectives of the save and of
    the restore (JSON)."""
    from t2v_torch.io.train_state import restore_train_state, save_train_state
    from t2v_torch.parallel import audit
    from t2v_torch.parallel import train as T
    from t2v_torch.parallel.sharding import tp_layout

    layout = tp_layout(unet, mesh.tp.size)
    state, step = _step(unet, "full", mesh, layout, ema=0.9)
    glob = {k: torch.from_numpy(v) for k, v in batch().items()}
    step(state, T.local_batch(mesh, glob), None, draw)
    with audit.recording() as saved:
        save_train_state(str(out), state, mode={"ema": True})
    torch.distributed.barrier()
    fresh, _ = _step(unet, "full", mesh, layout, ema=0.9)
    with audit.recording() as restored:
        fresh = restore_train_state(str(out), fresh)
    same = fresh.step == state.step == 1
    for (_, a), (_, b), (_, ea), (_, eb) in zip(T.tree_items(state.params),
                                                T.tree_items(fresh.params),
                                                T.tree_items(state.ema_params),
                                                T.tree_items(fresh.ema_params)):
        ma, mb = state.opt_state.state[a], fresh.opt_state.state[b]
        same &= a.shape == b.shape and torch.equal(a, b) and torch.equal(ea, eb)
        same &= all(torch.equal(ma[k], mb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    return bool(same), {"save": saved.to_json(), "restore": restored.to_json()}


def _shard_round_trip(mesh) -> dict:
    """Every parameter of both tiny UNets cut to this rank's tp piece and
    gathered back: (split parameters, GEGLU halves among them, all exact)."""
    from t2v_torch.parallel.sharding import gather_params, shard_params, tp_layout

    report = {}
    for family in ("ms", "vc"):
        sd = dict(seeded_unet(family).state_dict())
        layout = tp_layout(seeded_unet(family), mesh.tp.size)
        back = gather_params(shard_params(sd, layout, mesh.tp), layout, mesh.tp)
        report[family] = [len(layout), sum(layout.values()),
                          all(torch.equal(back[k], v) for k, v in sd.items())]
    return report


def main(rank: int, world: int, port: int, out: Path) -> None:
    from t2v_torch.cli import train as cli
    from t2v_torch.parallel import multihost
    from t2v_torch.parallel.mesh import Axis, get_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        meshes = {name: get_mesh(**shape) for name, shape in MESHES.items()}
        with np.load(out / "draw.npz") as d:
            draw = (torch.from_numpy(d["t"]), torch.from_numpy(d["noise"]))
        unets = {fam: seeded_unet(fam) for fam in ("ms", "vc")}
        cases = {name: run_case(unets[fam], kind, meshes[mesh], draw)
                 for name, fam, kind, mesh in CASES}
        cases["vc_full_sp_tp_remat"] = run_case(unets["vc"], "full", meshes["sp_tp"], draw,
                                                remat=True)
        cases["ms_full_tp_gather_fault"] = run_case(unets["ms"], "full", meshes["tp"], draw,
                                                    fault=True)
        sound = Axis.all_reduce_sum
        Axis.all_reduce_sum = lambda self, t, backward: sound(self, t, "identity")
        try:
            cases["vc_full_sp_fault"] = run_case(unets["vc"], "full", meshes["sp"], draw)
        finally:
            Axis.all_reduce_sum = sound
        same, state_audit = _state_round_trip(unets["ms"], meshes["sp_tp"], draw, out / "state")
        checks = {"state_round_trip": same, "shard_round_trip": _shard_round_trip(meshes["sp_tp"]),
                  "cli": {}}
        audits = {name: case.pop("audit") for name, case in cases.items() if case is not None}
        (out / f"audit{rank}.json").write_text(json.dumps({**audits, "state": state_audit}))
        if (out / "data").is_dir():
            for name in CLI_MESHES:
                argv = cli_argv(out / "data", out / f"cli_{name}", name)
                with recorded_losses() as losses:
                    codes = [cli.main([*argv, "--steps", "2"]),
                             cli.main([*argv, "--steps", "3", "--resume"])]
                checks["cli"][name] = {"codes": codes, "losses": losses}
        if rank == 0:
            torch.save(cases, out / "cases.pt")
            (out / "checks.json").write_text(json.dumps(checks))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
