"""The depth-adapter modules of the port against the JAX package's, in
float32 on the CPU: the T2I-Adapter and its config inference, MiDaS v2.1
small (tiny config, BatchNorms live and folded), the ``get_batch_depth``
resizes and normalisation, ``prepare_depth_frames`` and ``DepthStage`` with
a stub estimator and from a checkpoint.

Weights go from the port to JAX through the JAX package's own converters
(``convert_adapter``, ``convert_midas_small``): the port's modules carry
the published checkpoints' names. Tolerance: 1e-5 of the output's largest
magnitude (float32 on both sides in another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import t2v.models.depth as jdepth
from t2v.io.convert_depth import convert_midas_small
from t2v.models import adapter as jadapter
from t2v_torch.io import convert
from t2v_torch.models import adapter as tadapter
from t2v_torch.models import depth as tdepth
from t2v_torch.pipeline.pipeline import init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def _perturbed(module: torch.nn.Module, seed: int) -> dict:
    """Seeded init with every leaf perturbed and random BatchNorm statistics;
    returns the numpy state dict."""
    init_weights(module, seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(size=tuple(b.shape)).astype(np.float32)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2, tuple(b.shape)).astype(np.float32)))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_pixel_unshuffle_is_torch_order_as_in_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(np.float32)
    got = tadapter.pixel_unshuffle(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jadapter.pixel_unshuffle(x, 8)))
    ref = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("cfg", [
    tadapter.AdapterConfig(channels=(16, 32, 64, 64), nums_rb=2, ksize=1, sk=True,
                           use_conv=False),
    tadapter.AdapterConfig(channels=(16, 32, 64, 64), nums_rb=2),
], ids=["depth", "conv"])
def test_adapter_matches_jax(cfg):
    """Both published block layouts (the depth adapter's 1x1 convs,
    identity skips and pooling; the default 3x3 convs, ``skep`` and conv
    downsampling): the config read back from the state dict equals the JAX
    package's reading, and the four features match its ``Adapter`` on the
    JAX converter's parameters."""
    adapter = tadapter.Adapter(cfg).eval()
    sd = _perturbed(adapter, 1)
    jcfg = jadapter.infer_adapter_config(sd)
    assert tadapter.infer_adapter_config(sd) == cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    x = np.random.default_rng(2).uniform(-1, 1, (3, 64, 64, 1)).astype(np.float32)
    want = jadapter.Adapter(cfg=jcfg).apply(jadapter.convert_adapter(sd, jcfg), jnp.asarray(x))
    with torch.no_grad():
        got = adapter(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(3, 8, 8, 16), (3, 4, 4, 32), (3, 2, 2, 64),
                                           (3, 1, 1, 64)]
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def test_depth_adapter_config_is_the_published_one():
    assert (dataclasses.asdict(tadapter.AdapterConfig.depth_adapter())
            == dataclasses.asdict(jadapter.AdapterConfig.depth_adapter()))
    with torch.device("meta"):
        adapter = tadapter.Adapter(tadapter.AdapterConfig.depth_adapter())
    assert sum(p.numel() for p in adapter.parameters()) == 77_000_640
    assert not any(k.endswith("skep.weight") or ".down_opt." in k for k in adapter.state_dict())


def test_midas_small_matches_jax():
    """A tiny MidasSmall (one block a stage) against the JAX network on the
    JAX converter's folded parameters, with the BatchNorms live in eval mode
    and after ``fold_batchnorm``."""
    cfg = tdepth.MidasSmallConfig().tiny()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jdepth.MidasSmallConfig().tiny())
    model = tdepth.MidasSmall(cfg).eval()
    sd = _perturbed(model, 3)
    # the converter reads each stage's repeats from the module's table
    full = jdepth._LITE3_STAGES
    jdepth._LITE3_STAGES = cfg.stages
    try:
        params = convert_midas_small(sd)
    finally:
        jdepth._LITE3_STAGES = full
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jdepth.MidasSmall(cfg=jdepth.MidasSmallConfig().tiny()).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        live = model(torch.from_numpy(x)).numpy()
        folded = model.fold_batchnorm()(torch.from_numpy(x)).numpy()
    assert want.shape == (2, 64, 64) and (want >= 0).all()
    _close(live, want)
    _close(folded, want)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_full_midas_names_are_the_converters():
    """The full network's state dict is what the JAX package's converter
    reads from a ``midas_v21_small`` checkpoint, key for key (the deepest
    fusion block's ``resConfUnit1`` is carried and unused in both)."""
    with torch.device("meta"):
        model = tdepth.MidasSmall()
    shapes = {k: np.zeros(tuple(v.shape), np.float32) for k, v in model.state_dict().items()}
    read = set()

    class Reads(dict):
        def __getitem__(self, k):
            read.add(k)
            return super().__getitem__(k)

    convert_midas_small(Reads(shapes))
    unused = {k for k in shapes if k.endswith("num_batches_tracked")
              or k.startswith("scratch.refinenet4.resConfUnit1.")}
    assert read == set(shapes) - unused
    assert sum(v.numel() for k, v in model.state_dict().items()
               if "running" not in k and "num_batches" not in k) == 21_320_545


def test_resizes_match_jax():
    """``normalize_depth``'s antialiased Keys-cubic resize against
    ``jax.image.resize`` at a shrinking and a growing shape (and against
    torch's antialiased bicubic, which uses the same kernel), and the
    decoder's bilinear 2x against the JAX package's ``_resize_bilinear``."""
    d = np.random.default_rng(5).uniform(0, 3, (3, 12, 20)).astype(np.float32)
    for hw in ((5, 7), (30, 44)):
        want = np.asarray(jdepth.normalize_depth(jnp.asarray(d), hw))
        got = tdepth.normalize_depth(torch.from_numpy(d), hw)
        assert got.shape == (3, *hw, 1) and got.dtype == torch.float32
        _close(got.numpy(), want)
        raw = jax.image.resize(jnp.asarray(d), (3, *hw), method="cubic")
        _close(tdepth.resize(torch.from_numpy(d), hw).numpy(), np.asarray(raw))
        aa = F.interpolate(torch.from_numpy(d)[:, None], size=hw, mode="bicubic",
                           antialias=True)[:, 0]
        _close(aa.numpy(), np.asarray(raw))
    x = np.random.default_rng(6).normal(size=(2, 3, 5, 7)).astype(np.float32)
    want = np.asarray(jdepth._resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), (10, 14)))
    got = tdepth.resize_bilinear(torch.from_numpy(x), (10, 14)).numpy()
    _close(got, want.transpose(0, 3, 1, 2))


def test_prepare_depth_frames_matches_jax():
    rng = np.random.default_rng(7)
    for frames in (rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8),
                   rng.uniform(-1, 1, (1, 48, 32, 3)).astype(np.float32)):
        got = tdepth.prepare_depth_frames(frames)
        assert got.shape == (len(frames), 384, 384, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jdepth.prepare_depth_frames(frames))


def test_depth_stage_with_a_stub_estimator_matches_jax():
    """Ten frames in two chunks of at most 8, through the same stub on both
    sides: (N, 384, 384, 3) -> a (N, 48, 48) depth, then resized to the
    target and normalised per frame."""
    frames = np.random.default_rng(8).integers(0, 256, (10, 24, 40, 3)).astype(np.uint8)
    seen = []

    def stub(f):
        seen.append(tuple(f.shape))
        return f[:, ::8, ::8].mean(-1)

    want = jdepth.DepthStage(estimator=lambda f: f[:, ::8, ::8].mean(-1)).video_depth(
        frames, (20, 36))
    got = tdepth.DepthStage(stub).video_depth(frames, (20, 36))
    assert seen == [(8, 384, 384, 3), (2, 384, 384, 3)]
    _close(got.numpy(), want)
    assert got.amin() == -1.0 and abs(float(got.amax()) - 1.0) < 1e-6


def test_depth_stage_from_a_checkpoint(tmp_path):
    """A ``midas_v21_small``-layout torch file (under ``state_dict``,
    without the BatchNorm counters) loads folded and matches the live
    network; a missing or malformed file raises, naming it."""
    cfg = tdepth.MidasSmallConfig().tiny()
    model = tdepth.MidasSmall(cfg).eval()
    _perturbed(model, 9)
    path = tmp_path / "midas.pt"
    torch.save({"state_dict": {k: v for k, v in model.state_dict().items()
                               if not k.endswith("num_batches_tracked")}}, path)
    stage = tdepth.DepthStage.from_checkpoint(str(path), device="cpu", cfg=cfg)
    x = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32))
    with torch.no_grad():
        _close(stage.estimator(x).numpy(), model(x).numpy())
    with pytest.raises(FileNotFoundError, match="absent.pt"):
        tdepth.DepthStage.from_checkpoint(str(tmp_path / "absent.pt"), device="cpu")
    torch.save({"state_dict": {"conv.weight": torch.zeros(1)}}, tmp_path / "other.pt")
    with pytest.raises(KeyError, match="other.pt: not a midas_v21_small checkpoint"):
        tdepth.DepthStage.from_checkpoint(str(tmp_path / "other.pt"), device="cpu")
    assert convert.load_torch_checkpoint(str(path))["state_dict"]
