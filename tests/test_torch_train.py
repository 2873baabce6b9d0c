"""The port's training path against the JAX package's, in fp32 on the CPU
at the tiny ModelScope UNet (and the tiny VideoCrafter UNet for the CLI).

* the loss and the gradients of ``diffusion_loss`` for the eps, x0 and v
  targets against ``jax.value_and_grad`` of the JAX ``diffusion_loss`` fed
  the same ``(t, noise)`` (recomputed here as the JAX function draws them
  from its key). One JAX program differentiates the LoRA-merged loss with
  respect to the base weights (the full fine-tune's gradients) and to A and
  B (the LoRA step's) at once, since each JAX gradient program of the tiny
  UNet costs about 16 s to compile. Tolerance: 2e-4 of the largest
  |gradient| of each leaf's tree, absolute (float32 on both sides in
  another summation order through some 20 blocks, forward and backward);
  the loss to rtol 1e-5;
* AdamW and the EMA rule against ``optax.adamw`` and the JAX ``_ema_update``
  fed the same gradients for three steps (atol 1e-6): the optimizers are
  compared apart from the gradients, since Adam's first step is lr * sign(g)
  and magnifies a 1e-7 difference in a tiny g;
* a rematerialised step against a plain one, a train state saved and
  restored against one that was not, the CLI for two steps on a clip
  written to ``tmp_path``, and the dataset's arrays against the JAX
  package's on that clip (the last three need ``cv2``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.io.convert import convert_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v.parallel import train as jtrain
from t2v.pipeline import lora as jlora
from t2v_torch.core.config import ModelScopeUNetConfig
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.io import convert, train_state
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.parallel import train as ttrain
from t2v_torch.pipeline import lora as tlora
from t2v_torch.pipeline.pipeline import init_weights
from _torch_model_dir import write_clip_dir
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ModelScopeUNetConfig().tiny()
PARAMETERIZATIONS = ("eps", "x0", "v")


@pytest.fixture(scope="module")
def setup():
    """A seeded tiny UNet with every leaf perturbed (no zero gate hides a
    gradient), its JAX tree, a LoRA tree with signal in A and B, a batch,
    and the (t, noise) that the JAX loss draws from its key."""
    unet = UNetSD(CFG).eval()
    init_weights(unet, 0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.02 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    jparams = convert_unet({k: v.numpy() for k, v in unet.state_dict().items()}, JCfg().tiny())
    jidx = jlora.unet_module_index(JCfg().tiny())
    lora = jlora.init_lora(jparams, jidx, rank=2, key=jax.random.key(1))
    lora = {n: {k: (0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in ab.items()}
            for n, ab in lora.items()}
    batch = {"latents": rng.normal(size=(2, 2, 8, 8, 4)).astype(np.float32),
             "context": rng.normal(size=(2, 7, CFG.context_dim)).astype(np.float32)}
    key = jax.random.key(3)
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(kn, batch["latents"].shape, jnp.float32))
    return dict(unet=unet, jparams=jparams, jidx=jidx, lora=lora, batch=batch, key=key,
                draw=(t, noise))


@pytest.fixture(scope="module")
def jax_losses_and_grads(setup):
    """{parameterization: (loss, d/d base weights, d/d LoRA)} from one
    jitted JAX program, compiled once: the LoRA-merged UNet forward and its
    VJP for a cotangent given as an argument. The three targets share the
    prediction, so a first call gives it, the JAX ``diffusion_loss`` handed
    that prediction gives each target's loss and cotangent d loss / d
    prediction (its own draw of t and noise, and the xt it builds, are
    checked against the ones the UNet was fed), and one more call each
    gives the gradients."""
    model = JUNet(cfg=JCfg().tiny())
    tables = jtrain.schedule_tables(JSchedule.linear_sd(1000))
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    t, noise = setup["draw"]
    sa = np.asarray(tables["sqrt_alphas_cumprod"])[t].reshape(-1, 1, 1, 1, 1)
    s1 = np.asarray(tables["sqrt_one_minus_alphas_cumprod"])[t].reshape(-1, 1, 1, 1, 1)
    xt = jnp.asarray(sa * setup["batch"]["latents"] + s1 * noise, jnp.float32)
    tt = jnp.asarray(t, jnp.float32)

    def forward_and_vjp(params, lora, cotangent):
        pred, vjp = jax.vjp(
            lambda p, lo: model.apply(jlora.apply_lora(p, lo, setup["jidx"], 1.5), xt, tt,
                                      batch["context"]), params, lora)
        return pred, vjp(cotangent)

    program = jax.jit(forward_and_vjp)
    args = (setup["jparams"], setup["lora"])
    pred, _ = program(*args, jnp.zeros_like(xt))

    def loss_of(pr, kind):
        def fed(params, x, ti, ctx):
            np.testing.assert_allclose(np.asarray(x), np.asarray(xt), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(ti), np.asarray(tt))
            return pr

        return jtrain.diffusion_loss(fed, None, tables, batch, setup["key"], kind)

    out = {}
    for kind in PARAMETERIZATIONS:
        loss, cotangent = jax.value_and_grad(lambda pr: loss_of(pr, kind))(pred)
        _, (g_full, g_lora) = program(*args, cotangent)
        out[kind] = (float(loss), jax.device_get(g_full), jax.device_get(g_lora))
    return out


def _port_loss_and_grads(setup, kind):
    unet = setup["unet"]
    base = {k: v.detach().clone().requires_grad_() for k, v in unet.named_parameters()}
    lora = convert.lora_from_jax(setup["lora"])
    idx = tlora.unet_module_index(CFG)
    merged = tlora.apply_lora(base, lora, idx, 1.5)
    tables = ttrain.schedule_tables(DiffusionSchedule.linear_sd(1000))
    batch = {k: torch.tensor(v) for k, v in setup["batch"].items()}
    t, noise = setup["draw"]
    loss = ttrain.diffusion_loss(ttrain.module_apply_fn(unet), merged, tables, batch, None, kind,
                                 draw=(torch.tensor(t), torch.tensor(noise)))
    names = list(base)
    lora_leaves = ttrain.tree_items(lora)
    grads = torch.autograd.grad(loss, [*base.values(), *(v for _, v in lora_leaves)])
    g_full = dict(zip(names, grads[: len(names)]))
    g_lora = {n: g for (n, _), g in zip(lora_leaves, grads[len(names):])}
    return float(loss.detach()), g_full, g_lora


@pytest.mark.parametrize("kind", PARAMETERIZATIONS)
def test_loss_and_full_gradients_match_jax(setup, jax_losses_and_grads, kind):
    want_loss, want_full, _ = jax_losses_and_grads[kind]
    loss, g_full, _ = _port_loss_and_grads(setup, kind)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    want = convert.from_jax_unet(want_full, CFG)   # a gradient tree has the weights' layouts
    assert want.keys() == g_full.keys()
    top = max(np.abs(w).max() for w in want.values())
    assert top > 1e-3
    for k, w in want.items():
        np.testing.assert_allclose(g_full[k].numpy(), w, atol=2e-4 * top, err_msg=k)


@pytest.mark.parametrize("kind", PARAMETERIZATIONS)
def test_loss_and_lora_gradients_match_jax(setup, jax_losses_and_grads, kind):
    want_loss, _, want_lora = jax_losses_and_grads[kind]
    loss, _, g_lora = _port_loss_and_grads(setup, kind)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    top = max(np.abs(g).max() for ab in want_lora.values() for g in ab.values())
    assert top > 1e-3 and len(g_lora) == 2 * len(want_lora)
    for name, ab in want_lora.items():
        for leaf, w in ab.items():
            np.testing.assert_allclose(g_lora[f"{name}.{leaf}"].numpy(), w, atol=2e-4 * top,
                                       err_msg=f"{name}.{leaf}")


def test_generator_draw_is_seeded_and_in_range(setup):
    tables = ttrain.schedule_tables(DiffusionSchedule.linear_sd(1000))
    batch = {k: torch.tensor(v) for k, v in setup["batch"].items()}
    seen = []
    apply_fn = lambda params, xt, t, ctx: (seen.append((xt, t)), xt * params["w"])[1]
    params = {"w": torch.ones((), requires_grad=True)}
    a = ttrain.diffusion_loss(apply_fn, params, tables, batch, torch.Generator().manual_seed(5))
    b = ttrain.diffusion_loss(apply_fn, params, tables, batch, torch.Generator().manual_seed(5))
    c = ttrain.diffusion_loss(apply_fn, params, tables, batch, torch.Generator().manual_seed(6))
    assert a.item() == b.item() != c.item()
    for _, t in seen:
        assert t.dtype == torch.float32 and t.shape == (2,) and (0 <= t).all() and (t < 1000).all()


def test_schedule_tables_match_jax():
    mine = ttrain.schedule_tables(DiffusionSchedule.linear_sd(1000))
    theirs = jtrain.schedule_tables(JSchedule.linear_sd(1000))
    assert mine["num_timesteps"] == theirs["num_timesteps"] == 1000
    for k in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(theirs[k]), rtol=1e-6)


@pytest.mark.parametrize("nested", [False, True], ids=["flat", "lora_tree"])
def test_adamw_and_ema_match_optax_on_the_same_gradients(nested):
    rng = np.random.default_rng(7)
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    tree = ({"m": {"lora_A": leaf(6, 2), "lora_B": leaf(2, 5)}, "n": {"lora_A": leaf(3, 2),
                                                                     "lora_B": leaf(2, 4)}}
            if nested else {"w": leaf(5, 4), "b": leaf(4), "s": leaf(1)})
    lr, wd, decay = 1e-2, 1e-2, 0.9
    state = ttrain.init_train_state(jax.tree.map(torch.tensor, tree),
                                    ttrain.make_optimizer(lr, wd), with_ema=True)
    jopt = jtrain.make_optimizer(lr, wd)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate, jema = jopt.init(jparams), jax.tree.map(jnp.asarray, tree)
    for step in range(3):
        grads = jax.tree.map(lambda a: leaf(*a.shape) * 10.0 ** -step, tree)
        for (_, p), g in zip(ttrain.tree_items(state.params), jax.tree.leaves(grads)):
            p.grad = torch.tensor(g)
        state.opt_state.step()
        ttrain._ema_update(state.ema_params, state.params, decay)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jema = jtrain._ema_update(jema, jparams, decay)
        for (name, p), want in zip(ttrain.tree_items(state.params), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"step {step} {name}")
        for (name, e), want in zip(ttrain.tree_items(state.ema_params), jax.tree.leaves(jema)):
            np.testing.assert_allclose(e.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"step {step} ema {name}")


def _batch(setup):
    return {k: torch.tensor(v) for k, v in setup["batch"].items()}


def _full_state(setup, with_ema=True):
    return ttrain.init_train_state(dict(setup["unet"].named_parameters()),
                                   ttrain.make_optimizer(1e-3), with_ema=with_ema)


def _lora_state_and_step(setup):
    unet = setup["unet"]
    base = dict(unet.named_parameters())
    idx = tlora.unet_module_index(CFG)
    state = ttrain.init_train_state(convert.lora_from_jax(setup["lora"]),
                                    ttrain.make_optimizer(1e-3))
    step = ttrain.make_lora_train_step(ttrain.module_apply_fn(unet), DiffusionSchedule.linear_sd(1000),
                                       base, idx, alpha=1.5)
    return state, step


def test_train_step_updates_a_copy_and_tracks_the_ema(setup):
    unet = setup["unet"]
    before = {k: v.detach().clone() for k, v in unet.named_parameters()}
    state = _full_state(setup)
    step = ttrain.make_train_step(ttrain.module_apply_fn(unet), DiffusionSchedule.linear_sd(1000),
                                  ema_decay=0.9)
    gen = torch.Generator().manual_seed(0)
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    state, loss = step(state, _batch(setup), gen)
    assert state.step == 1 and torch.isfinite(loss) and not loss.requires_grad
    for k, v in unet.named_parameters():
        assert torch.equal(v, before[k])                       # the module is untouched
        assert v.grad is None
        assert not torch.equal(state.params[k], before[k])     # the state's copy moved
        want = ema0[k] * 0.9 + state.params[k].detach() * 0.1
        np.testing.assert_allclose(state.ema_params[k].numpy(), want.numpy(), atol=1e-7)
        assert state.ema_params[k].dtype == torch.float32


def test_lora_step_updates_only_the_adapters(setup):
    unet = setup["unet"]
    before = {k: v.detach().clone() for k, v in unet.named_parameters()}
    state, step = _lora_state_and_step(setup)
    a0 = {n: t.detach().clone() for n, t in ttrain.tree_items(state.params)}
    state, loss = step(state, _batch(setup), torch.Generator().manual_seed(0))
    assert state.step == 1 and torch.isfinite(loss) and state.ema_params is None
    assert all(torch.equal(v, before[k]) and v.grad is None for k, v in unet.named_parameters())
    assert all(not torch.equal(t, a0[n]) for n, t in ttrain.tree_items(state.params))


def test_remat_step_equals_plain_step(setup):
    unet = setup["unet"]
    results = []
    for remat in (False, True):
        state = _full_state(setup, with_ema=False)
        step = ttrain.make_train_step(ttrain.module_apply_fn(unet),
                                      DiffusionSchedule.linear_sd(1000), remat=remat)
        gen = torch.Generator().manual_seed(1)
        losses = [step(state, _batch(setup), gen)[1].item() for _ in range(2)]
        results.append((losses, state.params))
    (l0, p0), (l1, p1) = results
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(p0[k].detach().numpy(), p1[k].detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_train_state_save_restore_gives_the_same_next_step(setup, tmp_path, mode):
    unet = setup["unet"]

    def fresh():
        if mode == "lora":
            return _lora_state_and_step(setup)
        return _full_state(setup), ttrain.make_train_step(
            ttrain.module_apply_fn(unet), DiffusionSchedule.linear_sd(1000), ema_decay=0.9)

    run_mode = {"lora_rank": 2 if mode == "lora" else 0, "ema": mode == "full"}
    state, step = fresh()
    state, _ = step(state, _batch(setup), torch.Generator().manual_seed(2))
    out = tmp_path / ("lora_state_1" if mode == "lora" else "step_1")
    assert not train_state.has_train_state(str(out))
    train_state.save_train_state(str(out), state, mode=run_mode)
    assert train_state.has_train_state(str(out))
    assert train_state.train_state_mode(str(out)) == run_mode
    (tmp_path / "step_0").mkdir()                          # no state inside: not a candidate
    assert train_state.latest_train_state(str(tmp_path)) == str(out)
    assert train_state.latest_train_state(str(tmp_path / "nowhere")) is None

    template, step2 = fresh()
    restored = train_state.restore_train_state(str(out), template)
    assert restored.step == 1
    for (_, a), (_, b) in zip(ttrain.tree_items(restored.params), ttrain.tree_items(state.params)):
        assert torch.equal(a, b)
    state, la = step(state, _batch(setup), torch.Generator().manual_seed(3))
    restored, lb = step2(restored, _batch(setup), torch.Generator().manual_seed(3))
    assert la.item() == lb.item() and restored.step == state.step == 2
    for (n, a), (_, b) in zip(ttrain.tree_items(restored.params), ttrain.tree_items(state.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-7, err_msg=n)
    if mode == "full":
        for k in state.ema_params:
            np.testing.assert_allclose(restored.ema_params[k].numpy(), state.ema_params[k].numpy(),
                                       atol=1e-7)
        bad = _lora_state_and_step(setup)[0]
        with pytest.raises(KeyError):
            train_state.restore_train_state(str(out), bad)


def test_webvid_arrays_equal_the_jax_datasets(tmp_path):
    pytest.importorskip("cv2")
    from t2v.data.webvid import WebVidDataset as JDataset
    from t2v_torch.data.webvid import WebVidDataset

    write_clip_dir(tmp_path)
    kw = dict(video_length=4, resolution=(32, 32), frame_stride=2, seed=5, trigger_word=" sks")
    mine, theirs = WebVidDataset(str(tmp_path), **kw), JDataset(str(tmp_path), **kw)
    assert len(mine) == len(theirs) == 1
    a, b = mine[0], theirs[0]
    assert a.caption == b.caption == "a cat sks" and a.fps == b.fps
    assert a.frames.shape == (4, 32, 32, 3) and a.frames.dtype == np.float32
    np.testing.assert_array_equal(a.frames, b.frames)
    (fa, ca), (fb, cb) = next(mine.batches(1)), next(theirs.batches(1))
    assert ca == cb
    np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("extra", [["--lora-rank", "2"], ["--ema-decay", "0.99"],
                                   ["--model-type", "VideoCrafter", "--remat"]],
                         ids=["lora", "full_ema", "videocrafter_remat"])
def test_cli_trains_two_steps_on_the_cpu_and_resumes(tmp_path, capsys, extra):
    pytest.importorskip("cv2")
    from t2v_torch.cli import train as cli
    from t2v_torch.io.safetensors_io import load_safetensors

    write_clip_dir(tmp_path / "data")
    out = tmp_path / "out"
    argv = ["--data-dir", str(tmp_path / "data"), "--tiny", "--device", "cpu", "--batch-size", "1",
            "--frames", "4", "--resolution", "32", "--log-every", "1", "--save-every", "2",
            "--out", str(out), *extra]
    assert cli.main([*argv, "--steps", "2"]) == 0
    text = capsys.readouterr().out
    assert "step 2 loss" in text and "nan" not in text
    if "--lora-rank" in extra:
        tensors, meta = load_safetensors(str(out / "lora_step_2.safetensors"))
        assert meta["rank"] == "2" and meta["step"] == "2" and meta[tlora.METADATA_TAG] == "true"
        # (a random-init UNet's zero head conv keeps every LoRA gradient at zero:
        # the file's layout is checked here, the training signal in the tests above)
        assert sum(k.endswith(".lora_A") for k in tensors) == len(tensors) // 2 > 0
        assert all(v.shape[0] == 2 for k, v in tensors.items() if k.endswith(".lora_A"))
        assert train_state.train_state_mode(str(out / "lora_state_2")) == {"lora_rank": 2,
                                                                            "ema": False}
    else:
        assert (out / "step_2" / "unet.safetensors").exists()
        assert train_state.has_train_state(str(out / "step_2"))
    assert cli.main([*argv, "--steps", "3", "--resume"]) == 0
    text = capsys.readouterr().out
    assert "resumed from" in text and "at step 2" in text and "step 3 loss" in text
    assert cli.main([*argv, "--steps", "3", "--resume"]) == 0
    assert "nothing to do" in capsys.readouterr().out


def test_cli_fine_tunes_a_model_dir_and_saves_a_loadable_one(tmp_path, capsys):
    """One full fine-tune step from a model directory (a tiny one in the
    trainer's own layout: a published-layout one implies the full VAE and
    text tower); the saved directory (weights, configs, the vocab) loads
    with ``from_model_dir``."""
    pytest.importorskip("cv2")
    from _torch_model_dir import VOCAB, source_pipeline
    from t2v_torch.cli import train as cli
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    write_clip_dir(tmp_path / "data")
    src = source_pipeline()
    model = train_state.save_weights(
        str(tmp_path / "model"), unet_params=dict(src.unet.named_parameters()), vae=src.vae,
        clip=src.text_encoder.model, unet_cfg=src.unet_cfg, vae_cfg=src.vae_cfg,
        clip_cfg=src.clip_cfg, model_family="modelscope", tokenizer_vocab=str(VOCAB))
    out = tmp_path / "out"
    assert cli.main(["--data-dir", str(tmp_path / "data"), "--model-dir", str(model), "--device",
                     "cpu", "--batch-size", "1", "--frames", "4", "--resolution", "32",
                     "--steps", "1", "--log-every", "1", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "step 1 loss" in text and "nan" not in text
    saved = out / "step_1"
    assert (saved / "bpe_simple_vocab_16e6.txt.gz").read_bytes() == VOCAB.read_bytes()
    pipe = ModelScopePipeline.from_model_dir(str(saved), Policy.fp32(), device="cpu")
    assert (pipe.unet_cfg, pipe.vae_cfg, pipe.clip_cfg) == (src.unet_cfg, src.vae_cfg, src.clip_cfg)
    trained, before = pipe.unet.state_dict(), src.unet.state_dict()
    assert any(not torch.equal(trained[k], before[k]) for k in before)
    for a, b in ((pipe.vae, src.vae), (pipe.text_encoder.model, src.text_encoder.model)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                    b.state_dict().values()))


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--sp", "2"], "--sp/--tp: training on a mesh is not ported yet .the "
                 "mesh-training slice", id="argv0---sp/--tp"),
    pytest.param(["--tp", "2"], "--sp/--tp: training on a mesh", id="argv1---sp/--tp"),
    (["--model-type", "VideoCrafter", "--model-dir", "x", "--vc-ckpt", "y"],
     "--vc-ckpt: a VideoCrafter checkpoint, taken with --model-type VideoCrafter and without "
     "--model-dir"),
    (["--vc-ckpt", "x"], "--vc-ckpt: a VideoCrafter checkpoint, taken with --model-type"),
    (["--model-type", "VideoCrafter", "--lora-rank", "2", "--tiny", "--device", "cpu"],
     "ModelScope only"),
    (["--tiny", "--device", "cpu", "--resume"], "no train state"),
])
def test_cli_refuses_by_name(tmp_path, argv, match):
    from t2v_torch.cli import train as cli

    with pytest.raises(SystemExit, match=match):
        cli.main(["--data-dir", str(tmp_path), "--out", str(tmp_path / "none"), *argv])


def test_cli_flags_are_the_jax_clis_plus_device():
    from t2v.cli.train import build_parser as j_parser
    from t2v_torch.cli.train import build_parser

    flags = lambda p: {a.option_strings[0]: a.default for a in p._actions if a.option_strings}
    mine, theirs = flags(build_parser()), flags(j_parser())
    assert set(mine) == set(theirs) | {"--device"}
    assert mine["--device"] == "cuda"
    assert {k: v for k, v in mine.items() if k != "--device"} == theirs
