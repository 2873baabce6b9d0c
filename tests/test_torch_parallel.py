"""Sharded sampling of the port (``t2v_torch/parallel``) against the JAX
package's ``parallel`` modules and against the port's own serial loop, on
the CPU in float32.

One module-scoped two-rank gloo group (``tests/_torch_ranks.py``, two
processes started when the module starts) runs the tiny UNets of both
families under tp = 2 and sp = 2 and ``run`` under dp = 2, tp = 2 and
sp = 2, while this process computes the JAX references.

Tolerances:
  * the work split, the seeds and the sharding rules: exactly;
  * ``dp_sample`` against the JAX package's on a toy model fed the same
    noise: 2e-5 absolute and relative (float32 elementwise math in another
    order over 4 steps of O(1) values);
  * the tp = 2 and sp = 2 UNet forwards against the JAX UNet's apply on the
    same weights: 2e-4 absolute and relative, as the unsharded port is held
    (``tests/test_torch_unet.py``); the sharded sums add float32 partials
    in another order;
  * two-rank dp frames: equal to the serial loop's (each rank runs one
    sample at the serial shapes, its noise from the same seed + i);
  * tp, sp and the one-process batched dp: PNG frames within 2 levels of
    the serial ones (float32 in another summation order, through the
    decode, rounded to uint8);
  * the collectives each rank issued (``parallel/audit.py``, recorded in
    the same runs): their calls and bytes exactly those that the sites the
    tp and sp hooks installed give, times the UNet calls.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import ModelScopeUNetConfig as JMS
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.io.convert import convert_unet
from t2v.io.convert_vc import convert_vc_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v.models.videocrafter_unet import VideoCrafterUNet as JVCUNet
from t2v.models.videocrafter_unet import VideoCrafterUNetConfig as JVC
from t2v.parallel import dp_sample as jdp
from t2v.parallel import multihost as jmh
from t2v.parallel.sharding import _spec_for_path
from t2v_torch.core.config import T2VOutputArgs
from t2v_torch.diffusion.schedules import (
    DiffusionSchedule,
    make_ddim_timesteps,
    modelscope_timesteps,
)
from t2v_torch.parallel import dp_sample as tdp
from t2v_torch.parallel import multihost as tmh
from t2v_torch.parallel.audit import (
    Census,
    Inventory,
    assert_no_param_gather,
    installed_sites,
    param_full_shapes,
)
from t2v_torch.parallel.sharding import shard_dim
from t2v_torch.pipeline import run as run_mod
import _torch_ranks as ranks_mod
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
UNET_TOL = dict(rtol=2e-4, atol=2e-4)
FRAME_LEVELS = 2
RANKS_TIMEOUT = 240


class _Ranks:
    """The two worker processes of the module's gloo group."""

    def __init__(self, out: Path):
        self.out = out
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        worker = Path(__file__).with_name("_torch_ranks.py")
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        self.procs = [subprocess.Popen([sys.executable, str(worker), str(r), "2", str(port),
                                        str(out)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, env=env)
                      for r in range(2)]
        self.logs = None

    def wait(self) -> Path:
        """The output directory, once both ranks ended; fails with their
        logs if one did not end well."""
        if self.logs is None:
            self.logs = [p.communicate(timeout=RANKS_TIMEOUT)[0].decode() for p in self.procs]
        codes = [p.returncode for p in self.procs]
        assert codes == [0, 0], f"rank exit codes {codes}:\n" + "\n".join(self.logs)
        return self.out

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Starts the two ranks with the module, so that they run while the
    JAX references compile."""
    group = _Ranks(tmp_path_factory.mktemp("ranks"))
    try:
        yield group
    finally:
        group.close()


@pytest.fixture(scope="module")
def unets():
    """The tiny seeded UNet of each family (``seeded_unet``), built once:
    the tests read it and do not change it."""
    return {family: ranks_mod.seeded_unet(family) for family in ("ms", "vc")}


def test_work_split_seeds_and_split_rules_match_jax(monkeypatch):
    """``local_shard`` and ``host_seed`` at every rank of 1-4 processes, and
    the split rules (batch over dp, frames over sp where sp divides them)
    against ``dp_spec`` on meshes of those sizes."""
    for world in (1, 2, 3, 4):
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        monkeypatch.setattr(tmh, "process_count", lambda w=world: w)
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            monkeypatch.setattr(tmh, "process_index", lambda r=rank: r)
            assert tmh.host_seed(42) == jmh.host_seed(42)
            assert tmh.is_primary() == jmh.is_primary()
            for n in (1, 2, 5, 7, 10):
                assert tmh.local_shard(n) == jmh.local_shard(n), (world, rank, n)

    class Mesh:  # what dp_spec reads of a mesh
        def __init__(self, dp, sp):
            self.shape = {"dp": dp, "sp": sp, "tp": 1}

    for dp in (1, 2, 3):
        for sp in (1, 2, 4):
            for n in (1, 2, 3, 6):
                for frames in (4, 6, 16, 24):
                    batch_ax, frame_ax = jdp.dp_spec(Mesh(dp, sp), n, (frames, 8, 8, 4), True)
                    assert tdp.frames_split(frames, sp) == (frame_ax == "sp")
                    shares = [tmh.local_shard(n, dp, d) for d in range(dp)]
                    assert sum(c for _, c in shares) == n
                    if batch_ax == "dp":  # the JAX package's even split, in order
                        assert shares == [(d * n // dp, n // dp) for d in range(dp)]


def _tagged(unet) -> dict:
    """The UNet's state dict with parameter i filled with the value i + 1,
    so that each JAX leaf the converter makes names its torch parameter."""
    return {k: np.full(tuple(v.shape), i + 1, np.float32)
            for i, (k, v) in enumerate(unet.state_dict().items())}


@pytest.mark.parametrize("family", ["ms", "vc"])
def test_sharding_rules_match_jax_for_every_unet_leaf(unets, family):
    """For every leaf of the tiny UNet, the port's rule (the torch dim that
    tp splits) against ``_spec_for_path`` through the JAX package's own
    converter: a (in, out) kernel split on out is a torch (out, in) weight
    split on dim 0, one split on in is split on dim 1."""
    unet = unets[family]
    sd = _tagged(unet)
    names = list(sd)
    params = (convert_unet(sd, JMS().tiny()) if family == "ms"
              else convert_vc_unet(sd, JVC().tiny()))
    want = {(None, "tp"): 0, ("tp", None): 1, ("tp",): 0, (): None}
    seen, split = set(), 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        leaf = np.asarray(leaf)
        ids = np.unique(leaf)
        assert len(ids) == 1, keys
        name = names[int(ids[0]) - 1]
        seen.add(name)
        got = shard_dim(name, sd[name].ndim)
        assert got == want[tuple(_spec_for_path(keys, leaf.ndim))], (keys, name)
        split += got is not None
    assert seen == set(names)
    assert split > 0


def _toy_jax(x, t, ctx):
    return 0.5 * jnp.tanh(x) + (1e-3 * t + 0.3 * ctx.mean(axis=(1, 2)))[:, None, None, None, None]


def _toy_torch(x, t, ctx):
    return 0.5 * torch.tanh(x) + (1e-3 * t + 0.3 * ctx.mean(dim=(1, 2)))[:, None, None, None, None]


def test_dp_sample_matches_jax():
    """Three samples of a toy model, one batched loop each side (no mesh),
    with the same numpy starting noise: DDIM_Gaussian, and DDIM at eta 0.3
    fed the JAX loop's own step draws."""
    from t2v.core import rng as jrng

    n, shape, steps = 3, (3, 4, 4, 4), 4
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(n, *shape)).astype(np.float32)
    cond = rng.normal(size=(1, 7, 8)).astype(np.float32)
    uncond = rng.normal(size=(1, 7, 8)).astype(np.float32)
    for sampler, eta in (("DDIM_Gaussian", 0.0), ("DDIM", 0.3)):
        kw = dict(steps=steps, sample_shape=shape, n_samples=n, guidance_scale=7.5, eta=eta,
                  sampler_name=sampler, seed=5)
        want = np.asarray(jdp.dp_sample(_toy_jax, JSchedule.linear_sd(), cond=jnp.asarray(cond),
                                        uncond=jnp.asarray(uncond), noise=jnp.asarray(noise),
                                        **kw))
        eta_key = jrng.stream(jrng.key_for_seed(5), "ddim_eta")
        draws = [np.array(jax.random.normal(jax.random.fold_in(eta_key, i), (n, *shape),
                                            jnp.float32)) for i in range(steps)]
        got = tdp.dp_sample(_toy_torch, DiffusionSchedule.linear_sd(), cond=torch.from_numpy(cond),
                            uncond=torch.from_numpy(uncond), noise=torch.from_numpy(noise),
                            step_noise=draws if eta else None, **kw)
        assert got.shape == (n, *shape)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=sampler)


def test_batched_noise_rows_are_the_serial_draws():
    from t2v_torch.core import rng

    rows, gens = tdp.batched_noise(7, 3, (2, 4, 4, 4), first=1)
    for i in range(3):
        serial = rng.generator(8 + i, "cpu")
        one = rng.latent_noise(serial, (1, 2, 4, 4, 4), "cpu")
        assert torch.equal(rows[i : i + 1], one)
        # each generator goes on as the serial loop's batch 1 + i does
        assert torch.equal(torch.randn(5, generator=gens[i]), torch.randn(5, generator=serial))


@pytest.mark.parametrize("family", ["ms", "vc"])
def test_tp_and_sp_unet_forwards_match_jax(family, ranks, unets):
    """The tiny UNet split over two ranks (tp = 2: every attention and
    feed-forward halved; sp = 2: two frames a rank) against the JAX UNet's
    apply on the same weights."""
    sd = {k: v.numpy() for k, v in unets[family].state_dict().items()}
    if family == "ms":
        params, model = convert_unet(sd, JMS().tiny()), JUNet(cfg=JMS().tiny())
    else:
        params, model = convert_vc_unet(sd, JVC().tiny()), JVCUNet(cfg=JVC().tiny())
    x, t, ctx = ranks_mod.unet_inputs()
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ctx)))
    got = torch.load(ranks.wait() / "unet.pt")
    for kind in ("tp", "sp"):
        out = got[f"{family}_{kind}"].numpy()
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, **UNET_TOL, err_msg=f"{family} {kind}")


def _frames(outdir: Path) -> list[np.ndarray]:
    """The PNG frames of each batch ``run`` wrote under ``outdir``."""
    import cv2

    batches = sorted(os.listdir(outdir), key=lambda d: (len(d), d))
    return [np.stack([cv2.imread(str(outdir / b / f)) for f in sorted(os.listdir(outdir / b))
                      if f.endswith(".png")]) for b in batches]


def _recorded_seed(outdir: Path) -> int:
    """The seed that ``run`` wrote into its first batch's ``args.txt``."""
    first = min(os.listdir(outdir), key=lambda d: (len(d), d))
    text = (outdir / first / "args.txt").read_text()
    return int(text.split("Seed: ")[1].split(",")[0])


@pytest.fixture(scope="module")
def serial(tmp_path_factory, ranks):
    """The serial loop's frames of every two-rank case's request, in this
    process, and the one-process batched dp run of each dp case; a request
    that several cases share (the dp, tp and sp cases of a family) runs
    once. A case with a random seed (-1) runs at the seed that the ranks'
    rank 0 wrote."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("serial")
    saved = run_mod._warm_pipe
    pipes, frames, runs = {}, {}, {}
    cases = sorted(ranks_mod.RUN_CASES, key=lambda c: c[3].get("seed") == -1)
    try:
        for case, family, kwargs, fields in cases:
            pipe = pipes.get(family) or pipes.setdefault(family,
                                                         ranks_mod.tiny_pipeline(family))
            if fields.get("seed") == -1:
                fields = {**fields, "seed": _recorded_seed(ranks.wait() / case)}
            for label, shards in (("serial", {}), ("batched", kwargs)):
                if label == "batched" and "dp_shards" not in kwargs:
                    continue
                key = (family, label, tuple(sorted(fields.items())))
                if key not in runs:
                    out = root / f"{case}_{label}"
                    run_mod.run(ranks_mod.request(fields),
                                T2VOutputArgs(skip_video_creation=True), pipe=pipe,
                                outdir=str(out), callback_interval=None, keep_in_vram=False,
                                **shards)
                    runs[key] = _frames(out)
                frames[case, label] = runs[key]
    finally:
        run_mod._warm_pipe = saved
    return frames


def test_two_rank_run_matches_serial(ranks, serial):
    """``run`` over two ranks: dp = 2 writes, from rank 0, the serial loop's
    frames (at eta 0.5 too: each sample continues its own seed + i stream);
    tp = 2 and sp = 2 come within ``FRAME_LEVELS`` of them. With a random
    seed, both ranks sample from rank 0's, which is the seed written."""
    out = ranks.wait()
    for case, family, kwargs, fields in ranks_mod.RUN_CASES:
        got, want = _frames(out / case), serial[case, "serial"]
        assert len(got) == len(want) == ranks_mod.REQUEST["batch_count"], case
        for g, w in zip(got, want):
            assert g.shape == w.shape == (ranks_mod.FRAMES, 32, 32, 3), case
            diff = np.abs(g.astype(int) - w.astype(int)).max()
            if "dp_shards" in kwargs:
                assert diff == 0, case
            else:
                assert diff <= FRAME_LEVELS, (case, diff)


def test_one_process_batched_run_matches_serial(serial):
    """``run(dp_shards=2)`` without a process group: both samples in one
    batched loop, within ``FRAME_LEVELS`` of the serial batches."""
    for case, family, kwargs, fields in ranks_mod.RUN_CASES:
        if "dp_shards" not in kwargs:
            continue
        for g, w in zip(serial[case, "batched"], serial[case, "serial"]):
            assert np.abs(g.astype(int) - w.astype(int)).max() <= FRAME_LEVELS, case


def test_two_rank_run_refuses_requests_that_leave_ranks_unused(ranks):
    """Under a group of two ranks, ``run`` refuses, on both ranks, a request
    with no shard count above 1, the VideoCrafter DDPM chain and a mesh of
    four ranks, naming why, and writes nothing for them."""
    out = ranks.wait()
    got = json.loads((out / "refusals.json").read_text())
    want = {"no_shards": "2 ranks were started, but no shard count is above 1",
            "vc_ddpm": "2 ranks were started, but the VideoCrafter DDPM chain runs the serial",
            "mesh_above_group": "a dp=2 x sp=1 x tp=2 mesh needs 4 ranks; 2 were started"}
    assert set(got) == {c for c, _, _ in ranks_mod.REFUSED_CASES} == set(want)
    for case, start in want.items():
        assert got[case].startswith(start), (case, got[case])
        assert not (out / case).exists(), case


def _audits(out: Path, rank: int) -> dict:
    """{case: (Inventory, Census)} that ``rank`` recorded."""
    raw = json.loads((out / f"audit{rank}.json").read_text())
    return {case: (Inventory.from_json(a["ops"]), Census.from_json(a["census"]))
            for case, a in raw.items()}


def _sites_called(census: Census) -> dict:
    return {k: v for k, v in census.site_calls.items() if k != "column-parallel"}


def _assert_unet_calls(inv: Inventory, census: Census, unet, tp: int, sp: int, calls: int,
                       label: str) -> None:
    """The inventory of ``calls`` UNet calls at tp x sp against the model:
    every site the hooks installed called once a call, and the collectives
    exactly those the sites give (``site_census``): at tp one float32
    all-reduce of each row-parallel site's output and nothing else; at sp
    one all-gather of each temporal site's frames, every gathered shape
    carrying all of them, and one all-reduce of 2 x batch x 32 groups
    floats at each frame GroupNorm; no all-gather of a full parameter."""
    sites = installed_sites(unet, tp, sp)
    assert sites and _sites_called(census) == {k: calls * n for k, n in sites.items()}, label
    assert inv.tally() == census.expected, label
    assert all(op.dtype == "float32" for op in inv.select(kind="all-reduce").ops), label
    if tp > 1:
        assert set(inv.tally()) == {("tp", "all-reduce", "forward")}, label
        assert len(inv.ops) == calls * sites["row-parallel"], label
    if sp > 1:
        gathers = inv.select(kind="all-gather").ops
        assert len(gathers) == calls * sites["temporal"], label
        assert all(shape[1] == ranks_mod.FRAMES for op in gathers for shape in op.shapes), label
        norms = inv.select(kind="all-reduce").ops
        assert len(norms) == calls * sites.get("group-norm", 0), label
        assert all(op.bytes == 2 * op.shapes[0][1] * 32 * 4 and op.shapes[0][2] == 32
                   for op in norms), label
    assert_no_param_gather(inv, param_full_shapes(unet))


@pytest.mark.parametrize("family", ["ms", "vc"])
def test_sharded_unet_calls_follow_the_communication_model(ranks, unets, family):
    """One tiny UNet call of each family at tp = 2 and at sp = 2, on each
    rank, recorded: the collectives the port's model gives its sites
    (``_assert_unet_calls``), calls and bytes."""
    unet = unets[family]
    for rank in range(2):
        audits = _audits(ranks.wait(), rank)
        for kind, (tp, sp) in (("tp", (2, 1)), ("sp", (1, 2))):
            inv, census = audits[f"unet_{family}_{kind}"]
            _assert_unet_calls(inv, census, unet, tp, sp, 1, f"{family} {kind} rank {rank}")


def test_sharded_requests_follow_the_communication_model(ranks, unets):
    """Every two-rank ``run`` case, recorded on each rank: rank 0's seed
    broadcast once, the UNet calls' collectives (``_assert_unet_calls``, one
    CFG-batched call a timestep of the sampler) and the final gathers, nothing else. At dp = 2
    no collective runs inside the sampling loop: the broadcast and one
    gather of the samples are all."""
    # the tiny VAE halves the width once
    steps, lat = ranks_mod.REQUEST["steps"], ranks_mod.REQUEST["width"] // 2
    n, f = ranks_mod.REQUEST["batch_count"], ranks_mod.FRAMES
    for rank in range(2):
        audits = _audits(ranks.wait(), rank)
        for case, family, kwargs, fields in ranks_mod.RUN_CASES:
            inv, census = audits[case]
            label = f"{case} rank {rank}"
            seed, *loop, gather = inv.ops
            assert (seed.kind, seed.axis, seed.shapes, seed.bytes) == \
                ("broadcast", "default", ((1,),), 8), label
            assert (gather.kind, gather.axis) == ("all-gather", "dp"), label
            if "dp_shards" in kwargs:  # one sample a rank, gathered
                assert not loop and census.expected == {}, label
                assert gather.shapes == ((2, 1, f, lat, lat, 4),), label
                continue
            assert gather.shapes == ((1, n, f, lat, lat, 4),), label
            tp, sp = kwargs.get("tp_shards", 1), kwargs.get("sp_shards", 1)
            if sp > 1:  # the frames of the finished latents, gathered
                final = loop.pop()
                assert (final.kind, final.axis, final.shapes) == \
                    ("all-gather", "sp", ((n, f, lat, lat, 4),)), label
            # one CFG-batched UNet call a timestep of the family's sampler
            calls = len(modelscope_timesteps(1000, steps) if family == "ms"
                        else make_ddim_timesteps(steps, 1000))
            _assert_unet_calls(Inventory(loop), census, unets[family], tp, sp, calls, label)
