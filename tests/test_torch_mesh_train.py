"""Training over a process mesh (``t2v_torch/parallel/train.py`` with a
``ProcessMesh``) against the JAX package's sharded train step, on the CPU
in float32.

One module-scoped four-rank gloo group (``tests/_torch_mesh_ranks.py``,
four one-thread processes started with the module) runs ModelScope full
and LoRA and VideoCrafter full steps at dp = 2, tp = 2 and sp = 2 (on two
of the ranks) and at sp = 2 x tp = 2 (on all four) on the tiny UNets
(``seeded_unet``: every leaf perturbed), while this process computes the
JAX references: ``t2v.parallel.train.make_train_step`` and
``make_lora_train_step`` over a dp = 1, sp = 2, tp = 2 mesh of four of the
eight virtual CPU devices, once a family and kind, with an optimizer that
hands its gradients back as its state. Both sides take the same global
batch and the ``(t, noise)`` that the JAX step draws from its key
(recomputed here and given to the ranks): the function does not depend on
the mesh. Not the full dp = 2, sp = 2, tp = 2 mesh: there the JAX step
gives exactly twice the gradient of every (3, C, C) temporal-conv weight
of ModelScope (the XLA-partitioned backward of ``spmd_temporal_conv_chain``),
while every mesh with an axis of size 1, and one device, give the serial
step's.

Tolerances:
  * the loss: 1e-5 relative (float32 sums in another order);
  * every gradient leaf: 1e-4 of the leaf's max |g|, or of 1e-2 of the
    tree's largest |g| where the leaf's own is smaller than that (a bias
    just ahead of a GroupNorm has a true gradient of 0, and both sides
    give float32 noise of 1e-10 there);
  * the parameters after the step: exactly those of the one-process
    ``apply_gradients`` fed the gathered gradients (AdamW and the EMA are
    elementwise, so a rank's pieces update as the whole tensor does);
  * ``remat=True`` under sp x tp: the loss and gradients of the plain
    step to 1e-6 (the recompute issues the same collectives);
  * the trainer CLI over sp = 2 x tp = 2 and dp = 2 x tp = 2 against the
    one-process run on the same clips and seed, before and after
    ``--resume``: every step's loss to 1e-5 relative, and every tensor it
    saved (weights, parameters, AdamW moments, EMA) to 1e-6 absolute. The
    parameters are of order 1 and the sums' order gives 1.2e-7 at most;
    a rank that encodes another rank's samples or frames moves AdamW's
    moments by 3e-4 to 1e-3 after two steps. (The loss alone would not
    show it: the trainer's random UNet starts with a zero output layer,
    so its first loss is the noise's mean square);
  * the shard -> gather round trip and a saved and restored sharded state:
    exactly;
  * the collectives of every step (``parallel/audit.py``, recorded in the
    same runs): exactly those that the sites the tp and sp hooks installed
    give (calls and bytes), plus one float32 gradient sum an axis above 1
    of sp and dp of 4 bytes a trainable element (and the loss's 4 bytes),
    and, for LoRA at tp, the factors of the split sites summed over tp;
  * a step with a planted per-call weight gather (``gather_fault``): its
    loss and gradients are the sound step's exactly, and the audit fails it.
"""

import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2v.core.config import ModelScopeUNetConfig as JMS
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.io.convert import convert_unet
from t2v.io.convert_vc import convert_vc_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v.models.videocrafter_unet import VideoCrafterUNet as JVCUNet
from t2v.models.videocrafter_unet import VideoCrafterUNetConfig as JVC
from t2v.parallel import train as jtrain
from t2v.parallel.mesh import MeshConfig, make_mesh
from t2v.pipeline import lora as jlora
from t2v_torch.core.config import ModelScopeUNetConfig, VideoCrafterUNetConfig
from t2v_torch.io import convert, train_state
from t2v_torch.io.safetensors_io import load_torch
from t2v_torch.parallel import train as ttrain
from t2v_torch.parallel.audit import (
    SAVE,
    Census,
    Inventory,
    assert_no_param_gather,
    installed_sites,
    param_full_shapes,
)
from t2v_torch.parallel.sharding import tp_layout
from t2v_torch.pipeline import lora as tlora
import _torch_mesh_ranks as mr
from _torch_model_dir import write_clip_dir
from _torch_ranks import seeded_unet
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5
STATE_ATOL = 1e-6
GRAD_SHARE, GRAD_FLOOR = 1e-4, 1e-2
RANKS_TIMEOUT = 300
JAX_KEY = 3
KINDS = ("ms_full", "ms_lora", "vc_full")


class _Ranks:
    """The worker processes of the module's gloo group."""

    def __init__(self, out: Path):
        self.out = out
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        worker = Path(__file__).with_name("_torch_mesh_ranks.py")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(mr.WORLD),
                                        str(port), str(out)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, env=env)
                      for r in range(mr.WORLD)]
        self.logs = None

    def wait(self) -> Path:
        if self.logs is None:
            self.logs = [p.communicate(timeout=RANKS_TIMEOUT)[0].decode() for p in self.procs]
        codes = [p.returncode for p in self.procs]
        assert codes == [0] * mr.WORLD, f"rank exit codes {codes}:\n" + "\n".join(self.logs)
        return self.out

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _jax_draw():
    """The global (t, noise) that the JAX step draws from its key."""
    kt, kn = jax.random.split(jax.random.key(JAX_KEY))
    shape = mr.batch()["latents"].shape
    t = np.asarray(jax.random.randint(kt, (shape[0],), 0, 1000))
    return t, np.asarray(jax.random.normal(kn, shape, jnp.float32))


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Writes the draw and, where cv2 is there, a clip directory, then
    starts the ranks with the module, so that they run while the JAX
    references compile (the tests ask for ``jax_steps`` first)."""
    out = tmp_path_factory.mktemp("mesh_ranks")
    t, noise = _jax_draw()
    np.savez(out / "draw.npz", t=t, noise=noise)
    if importlib.util.find_spec("cv2") is not None:
        write_clip_dir(out / "data", clips=mr.CLI_CLIPS)
    group = _Ranks(out)
    try:
        yield group
    finally:
        group.close()


@pytest.fixture(scope="module")
def unets():
    """The tiny seeded UNet of each family (``seeded_unet``), built once:
    the tests read it and do not change it."""
    return {family: seeded_unet(family) for family in ("ms", "vc")}


@pytest.fixture(scope="module")
def cases(ranks):
    return torch.load(ranks.wait() / "cases.pt")


@pytest.fixture(scope="module")
def checks(ranks):
    return json.loads((ranks.wait() / "checks.json").read_text())


def _grab_gradients():
    """An optax transformation whose state after an update is the
    gradients it was given, and whose updates are zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_steps():
    """{kind: (loss, {torch leaf name: gradient})} of one JAX step each,
    over a dp = 1, sp = 2, tp = 2 mesh; the three compile in threads (XLA
    compiles without the GIL)."""
    mesh = make_mesh(MeshConfig(dp=1, sp=2, tp=2), jax.devices()[:4])
    with ThreadPoolExecutor(len(KINDS)) as pool:
        return dict(zip(KINDS, pool.map(lambda kind: jax_reference(mesh, kind), KINDS)))


def jax_reference(mesh, kind: str) -> tuple[float, dict]:
    """(loss, {torch leaf name: gradient}) of one JAX step of ``kind`` over
    ``mesh``."""
    batch = {k: jnp.asarray(v) for k, v in mr.batch().items()}
    schedule, grab = JSchedule.linear_sd(1000), _grab_gradients()
    unet = seeded_unet(kind[:2])
    sd = {k: v.detach().numpy() for k, v in unet.state_dict().items()}
    if kind.startswith("ms"):
        params, model = convert_unet(sd, JMS().tiny()), JUNet(cfg=JMS().tiny())
    else:
        params, model = convert_vc_unet(sd, JVC().tiny()), JVCUNet(cfg=JVC().tiny())
    if kind == "ms_lora":
        lora = jax.tree.map(jnp.asarray, mr.lora_tree(unet))
        step = jtrain.make_lora_train_step(model.apply, grab, schedule, mesh, params,
                                           jlora.unet_module_index(JMS().tiny()),
                                           alpha=mr.ALPHA)
        state = jtrain.init_train_state(lora, grab, mesh)
    else:
        step = jtrain.make_train_step(model.apply, grab, schedule, mesh)
        state = jtrain.init_train_state(params, grab, mesh)
    state, loss = step(state, batch, jax.random.key(JAX_KEY))
    grads = jax.device_get(state.opt_state)
    if kind == "ms_lora":
        named = {f"{n}.{k}": np.asarray(v) for n, ab in grads.items() for k, v in ab.items()}
    elif kind == "ms_full":
        named = convert.from_jax_unet(grads, ModelScopeUNetConfig().tiny())
    else:
        named = convert.from_jax_vc_unet(grads, VideoCrafterUNetConfig().tiny())
    return float(loss), named


def _gradient_errors(got: dict, want: dict) -> dict:
    """{leaf: max abs error / its limit}; the gate passes when all are <= 1."""
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    assert top > 1e-3
    return {k: float(np.abs(got[k].numpy() - w).max()
                     / (GRAD_SHARE * max(np.abs(w).max(), GRAD_FLOOR * top)))
            for k, w in want.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_loss_and_gradients_match_jax(jax_steps, cases, kind):
    """dp = 2, tp = 2, sp = 2 and sp = 2 x tp = 2: the reported loss (the
    global mean) and every gradient leaf, gathered over tp, against the JAX
    step's."""
    want_loss, want = jax_steps[kind]
    for axis in mr.MESHES:
        case = cases[f"{kind}_{axis}"]
        np.testing.assert_allclose(case["loss"], want_loss, rtol=LOSS_RTOL, err_msg=axis)
        errors = _gradient_errors(case["grads"], want)
        worst = max(errors, key=errors.get)
        assert errors[worst] <= 1.0, f"{kind} {axis}: {worst} at {errors[worst]:.2f} of its limit"


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_optimizer_step_is_the_serial_one(cases, unets, kind):
    """The parameters after a mesh step (every rank's pieces updated by
    AdamW, gathered) equal a one-process AdamW step from the same start
    fed the same (gathered) gradients."""
    unet = unets[kind[:2]]
    for axis in mr.MESHES:
        case = cases[f"{kind}_{axis}"]
        if kind == "ms_lora":
            start = {n: {k: torch.tensor(v) for k, v in ab.items()}
                     for n, ab in mr.lora_tree(unet).items()}
        else:
            start = dict(unet.named_parameters())
        state = ttrain.init_train_state(start, ttrain.make_optimizer(mr.LR))
        names = [n for n, _ in ttrain.tree_items(state.params)]
        assert names == list(case["grads"]) == list(case["params"])
        step = ttrain.TrainStep(None)
        step.apply_gradients(state, [case["grads"][n] for n in names])
        for name, p in ttrain.tree_items(state.params):
            assert torch.equal(p.detach(), case["params"][name]), f"{kind} {axis} {name}"
            assert not torch.equal(p.detach(), dict(ttrain.tree_items(start))[name])


def test_planted_sp_fault_fails_the_gradient_gate(jax_steps, cases):
    """VideoCrafter at sp = 2 with the GroupNorm sums' backward taken as
    the identity (each rank's loss term then misses the other rank's share
    of the statistics' gradient): the loss is unchanged, the gradient gate
    must fail."""
    want_loss, want = jax_steps["vc_full"]
    fault = cases["vc_full_sp_fault"]
    np.testing.assert_allclose(fault["loss"], want_loss, rtol=LOSS_RTOL)
    errors = _gradient_errors(fault["grads"], want)
    assert max(errors.values()) > 10.0, max(errors.values())


def test_remat_under_sp_equals_the_plain_step(cases):
    """VideoCrafter at sp = 2 x tp = 2 with ``remat=True``."""
    plain, remat = cases["vc_full_sp_tp"], cases["vc_full_sp_tp_remat"]
    np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=1e-6)
    for name, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][name].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12, err_msg=name)


def test_shards_gather_back_and_a_sharded_state_restores(checks):
    """Every parameter of both tiny UNets cut to its tp = 2 pieces and
    gathered back exactly (ModelScope and VideoCrafter split their q/k/v,
    out and GEGLU projections, the packed GEGLU by its value and gate
    halves); a state sharded over sp = 2 x tp = 2 with AdamW moments and
    an EMA shadow, saved by rank 0 and restored on every rank, equals the
    live one."""
    for family, (split, halves, exact) in checks["shard_round_trip"].items():
        assert split > 0 and halves > 0 and exact, (family, split, halves)
    assert checks["state_round_trip"]


@pytest.fixture(scope="module")
def one_process_cli(ranks, tmp_path_factory):
    """{CLI mesh: (losses, out dir)} of the one-process trainer runs on the
    ranks' clips: two steps, then ``--resume`` to a third."""
    pytest.importorskip("cv2")
    from t2v_torch.cli import train as cli

    runs = {}
    for mesh in mr.CLI_MESHES:
        out = tmp_path_factory.mktemp(f"cli_{mesh}")
        argv = mr.cli_argv(ranks.out / "data", out, mesh, grouped=False)
        with mr.recorded_losses() as losses:
            codes = [cli.main([*argv, "--steps", "2"]),
                     cli.main([*argv, "--steps", "3", "--resume"])]
        assert codes == [0, 0]
        runs[mesh] = (losses, out)
    return runs


@pytest.mark.parametrize("mesh", list(mr.CLI_MESHES))
def test_cli_trains_over_a_mesh_and_resumes(checks, ranks, one_process_cli, mesh):
    """``cli.train --tiny --device cpu`` on four ranks, then ``--resume``:
    every step's loss is the one-process run's (so each rank encoded and
    trained on its own samples and frames, and the resumed state is the
    saved one cut to its pieces), and rank 0 wrote full-shape weights and
    states, the same names and shapes as the one-process run's, at steps 2
    and 3 (the one-process run takes three steps, the resumed one of them
    the third), each tensor the one-process run's."""
    got = checks["cli"][mesh]
    assert got["codes"] == [0, 0]
    want_losses, one_out = one_process_cli[mesh]
    assert len(got["losses"]) == len(want_losses) == 3
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    mesh_out = ranks.wait() / f"cli_{mesh}"
    for step in (2, 3):
        for what in ("unet.safetensors", "train_state.safetensors"):
            mine, _ = load_torch(str(mesh_out / f"step_{step}" / what))
            one, _ = load_torch(str(one_out / f"step_{step}" / what))
            assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in one.items()}
            for k, v in one.items():
                np.testing.assert_allclose(mine[k].numpy(), v.numpy(), rtol=0, atol=STATE_ATOL,
                                           err_msg=f"step_{step}/{what}: {k}")
        assert json.loads((mesh_out / f"step_{step}" / "train_state.json").read_text())["step"] \
            == step
    assert train_state.latest_train_state(str(mesh_out)) == str(mesh_out / "step_3")


def _audits(out: Path, rank: int) -> dict:
    return json.loads((out / f"audit{rank}.json").read_text())


def _mesh_ranks(mesh: str) -> range:
    shape = mr.MESHES[mesh]
    return range(shape.get("dp", 1) * shape.get("sp", 1) * shape.get("tp", 1))


def _gradient_sums(kind: str, mesh: str, unet) -> dict:
    """The gradient sums of one step of ``kind`` over ``mesh``, as
    ``Inventory.tally`` reads them: for each axis above 1 of sp and dp one
    float32 bucket of every trainable leaf of the rank (its tp piece of a
    split parameter; a LoRA tree's factors, whole) and the loss's own; at
    tp, the LoRA factors of the split sites."""
    shape = {"dp": 1, "sp": 1, "tp": 1, **mr.MESHES[mesh]}
    layout = tp_layout(unet, shape["tp"])
    tp_summed = 0
    if kind == "ms_lora":
        index = tlora.unet_module_index(ModelScopeUNetConfig().tiny())
        leaves = {f"{n}.{k}": v.size for n, ab in mr.lora_tree(unet).items() for k, v in ab.items()}
        tp_summed = sum(v for n, v in leaves.items() if index[n.rsplit(".", 1)[0]][0] in layout)
    else:
        leaves = {n: p.numel() // (shape["tp"] if n in layout else 1)
                  for n, p in unet.named_parameters()}
    want = {(axis, "all-reduce", "gradient sum"): [2, 4 * sum(leaves.values()) + 4]
            for axis in ("sp", "dp") if shape[axis] > 1}
    if shape["tp"] > 1 and tp_summed:
        want["tp", "all-reduce", "gradient sum"] = [1, 4 * tp_summed]
    return want


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_steps_follow_the_communication_model(ranks, unets, kind):
    """Every rank's step of every mesh, recorded: each site the tp and sp
    hooks installed called once; forward and backward collectives exactly
    those the sites give (``site_census``; every sp gather carrying all the
    frames); the gradient sums of ``_gradient_sums``; nothing else, and no
    all-gather of a full parameter outside the test's own gathers (the save
    phase)."""
    unet = unets[kind[:2]]
    full = param_full_shapes(unet)
    for mesh, shape in mr.MESHES.items():
        tp, sp = shape.get("tp", 1), shape.get("sp", 1)
        sites = installed_sites(unet, tp, sp)
        for rank in _mesh_ranks(mesh):
            label = f"{kind} {mesh} rank {rank}"
            audit = _audits(ranks.wait(), rank)[f"{kind}_{mesh}"]
            inv, census = Inventory.from_json(audit["ops"]), Census.from_json(audit["census"])
            called = {k: v for k, v in census.site_calls.items() if k != "column-parallel"}
            assert called == dict(sites), label
            step = inv.select(phases=("forward", "backward", "gradient sum"))
            assert step.tally() == {**census.expected, **_gradient_sums(kind, mesh, unet)}, label
            assert all(dims[1] == mr.FRAMES for op in inv.select(axis="sp", kind="all-gather").ops
                       for dims in op.shapes), label
            assert all((op.kind, op.axis) == ("all-gather", "tp")
                       for op in inv.select(phases=(SAVE,)).ops), label
            assert_no_param_gather(inv, full)


def test_planted_weight_gather_passes_the_numeric_gate_and_fails_the_audit(jax_steps, cases,
                                                                           ranks, unets):
    """ModelScope full at tp = 2 with one row-parallel site that gathers its
    full out-projection weight at every call and drops it: its loss and
    every gradient are the sound tp step's exactly (so within the gate
    against the JAX step), and ``assert_no_param_gather`` fails its
    inventory, on both ranks, where it passes the sound step's."""
    want_loss, want = jax_steps["ms_full"]
    fault, sound = cases["ms_full_tp_gather_fault"], cases["ms_full_tp"]
    assert fault["loss"] == sound["loss"]
    assert all(torch.equal(fault["grads"][k], g) for k, g in sound["grads"].items())
    np.testing.assert_allclose(fault["loss"], want_loss, rtol=LOSS_RTOL)
    assert max(_gradient_errors(fault["grads"], want).values()) <= 1.0
    full = param_full_shapes(unets["ms"])
    for rank in _mesh_ranks("tp"):
        audits = _audits(ranks.wait(), rank)
        assert_no_param_gather(Inventory.from_json(audits["ms_full_tp"]["ops"]), full)
        with pytest.raises(AssertionError, match="rebuilds full parameter shapes"):
            assert_no_param_gather(Inventory.from_json(audits["ms_full_tp_gather_fault"]["ops"]),
                                   full)


def test_sharded_state_save_gathers_full_parameters_only_in_the_save_phase(ranks, unets):
    """The save of the sp = 2 x tp = 2 state: the ranks of rank 0's tp group
    gather each split leaf of the parameters, both AdamW moments and the
    EMA shadow over tp, whole (4 x the layout's leaves, every one a full
    parameter's shape), all in the save phase, which the audit leaves out;
    the other ranks issue nothing; the restore issues nothing. The same
    gathers outside the save phase fail the audit."""
    unet = unets["ms"]
    layout = tp_layout(unet, 2)
    shapes = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    full = param_full_shapes(unet)
    for rank in _mesh_ranks("sp_tp"):
        state = _audits(ranks.wait(), rank)["state"]
        saved, restored = Inventory.from_json(state["save"]), Inventory.from_json(state["restore"])
        assert not restored.ops, rank
        if rank >= 2:  # sp index 1: not of rank 0's tp group
            assert not saved.ops, rank
            continue
        assert [(op.kind, op.axis, op.phase) for op in saved.ops] == \
            [("all-gather", "tp", SAVE)] * 4 * len(layout), rank
        assert [op.shapes for op in saved.ops] == [(shapes[n],) for n in layout] * 4, rank
        assert_no_param_gather(saved, full)
        with pytest.raises(AssertionError, match="rebuilds full parameter shapes"):
            assert_no_param_gather(
                Inventory([dataclasses.replace(op, phase="forward") for op in saved.ops]), full)
