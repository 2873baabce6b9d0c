"""Guards of the PyTorch port: it imports nothing of JAX, flax or the JAX
package, nor pandas (the GPU host has none); its entry points refuse CUDA on
a host without a card; its kernel wrappers import on a CPU-only host and
refuse what their kernels do not take; its own copies of the JAX package's
host modules (configs, schedules, the WebVid dataset, the safetensors
reader, the job state, the keyframe DSL) agree with them.
"""

import ast
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import config as jconfig
from t2v.diffusion import schedules as jschedules
from t2v.models import videocrafter_unet as jvc
from t2v_torch.core import config as tconfig
from t2v_torch.core import rng as trng
from t2v_torch.diffusion import schedules as tschedules
from t2v_torch.kernels import _build
from t2v_torch.kernels import flash_attention as tflash
from t2v_torch.kernels import fused_mha as tfused
from t2v_torch.kernels import relpos_mha as trelpos
from t2v_torch.kernels import temporal_conv as ttc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "t2v", "pandas")


def _port_sources():
    return sorted((REPO / "t2v_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_import_loads_no_jax_module():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "t2v_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_cuda_entry_point_raises_without_a_card():
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no GPU"):
        ModelScopePipeline.random_init()


def test_videocrafter_entry_point_raises_without_a_card():
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no GPU"):
        VideoCrafterPipeline.random_init(tconfig.VideoCrafterUNetConfig().tiny())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_modules_build_nothing_at_import():
    assert _build._libs == {}
    assert set(_build.KERNELS) == {p.stem for p in _build.CSRC.glob("*.cu")}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _chain_args(c=64):
    x = _bf16(2, 3, 8, c)
    fin = torch.zeros(2, 2, c)
    vec = torch.zeros(c)
    return dict(x=x, fin=fin, scale=vec, bias=vec, w=_bf16(3, c, c), cb=vec)


@pytest.mark.parametrize("bad", [
    dict(x=torch.zeros(2, 3, 8, 64)),                          # float32
    dict(x=_bf16(2, 8, 3, 64).transpose(1, 2)),                # not contiguous
    dict(x=_bf16(2, 3, 8, 48), fin=torch.zeros(2, 2, 48)),     # C not a multiple of 64
    dict(w=_bf16(3, 64, 32)),                                  # wrong weight shape
    dict(w=torch.zeros(3, 64, 64)),                            # float32 weight
    dict(fin=torch.zeros(2, 64)),                              # wrong stats shape
    dict(scale=torch.zeros(32)),                               # wrong GroupNorm width
])
def test_temporal_conv_refuses(bad):
    args = {**_chain_args(), **bad}
    with pytest.raises(ValueError):
        ttc.check_layer_args(**args)
    ttc.check_layer_args(**_chain_args())


@pytest.mark.parametrize("q,k,v", [
    (torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.zeros(2, 8, 64)),   # float32
    (_bf16(2, 8, 48), _bf16(2, 8, 48), _bf16(2, 8, 48)),                     # head dim 48
    (_bf16(2, 8, 64), _bf16(2, 9, 64), _bf16(2, 8, 64)),                     # k/v lengths differ
    (_bf16(2, 64, 8).transpose(1, 2), _bf16(2, 8, 64), _bf16(2, 8, 64)),     # not contiguous
    (_bf16(16, 64), _bf16(16, 64), _bf16(16, 64)),                           # 2-D
])
def test_flash_refuses(q, k, v):
    with pytest.raises(ValueError):
        tflash.check_args(q, k, v)


@pytest.mark.parametrize("q,heads", [
    (torch.zeros(2, 24, 128), 2),             # float32
    (_bf16(2, 24, 96), 3),                    # head dim 32
    (_bf16(2, 512, 128), 2),                  # N too long for the short-sequence kernel
    (_bf16(2, 128, 24).transpose(1, 2), 2),   # not contiguous
])
def test_fused_mha_refuses(q, heads):
    with pytest.raises(ValueError):
        tfused.check_args(q, q, q, heads)
    tfused.check_args(_bf16(2, 24, 128), _bf16(2, 24, 128), _bf16(2, 24, 128), 2)


@pytest.mark.parametrize("q,k,heads", [
    (torch.zeros(2, 24, 128), torch.zeros(2, 77, 128), 2),   # float32
    (_bf16(2, 24, 96), _bf16(2, 77, 96), 3),                 # head dim 32
    (_bf16(2, 24, 128), _bf16(3, 77, 128), 2),               # context batch differs
    (_bf16(2, 24, 128), _bf16(2, 77, 64), 2),                # context width differs
    (_bf16(2, 24, 128), _bf16(2, 512, 128), 2),              # context too long
    (_bf16(2, 24, 128), _bf16(2, 128, 77).transpose(1, 2), 2),   # not contiguous
    (_bf16(24, 128), _bf16(77, 128), 2),                     # 2-D
])
def test_fused_cross_mha_refuses(q, k, heads):
    with pytest.raises(ValueError):
        tfused.check_cross_args(q, k, k, heads)
    tfused.check_cross_args(_bf16(2, 24, 128), _bf16(2, 77, 128), _bf16(2, 77, 128), 2)


@pytest.mark.parametrize("dh", tfused.HEAD_DIMS)
def test_packed_kernels_take_the_models_head_dims(dh):
    x = _bf16(2, 24, 2 * dh)
    tfused.check_args(x, x, x, 2)
    tfused.check_cross_args(x, _bf16(2, 77, 2 * dh), _bf16(2, 77, 2 * dh), 2)
    if dh != 64:  # 64 is also the ModelScope width
        assert dh in tflash.SUPPORTED_D
    tflash.check_args(_bf16(2, 600, dh), _bf16(2, 600, dh), _bf16(2, 600, dh))


def _relpos_args(**over):
    x, table = _bf16(8, 6, 80), _bf16(4, 4, 40)   # 2 samples x 4 frames, 2 heads of 40
    args = dict(q=x, k=x, v=x, k2=table, v2=table, heads=2, frame_split=4)
    args.update(over)
    return args


@pytest.mark.parametrize("bad", [
    dict(q=torch.zeros(8, 6, 80)),                        # float32
    dict(k=_bf16(8, 5, 80)),                              # shapes differ
    dict(frame_split=3),                                  # does not divide B*T
    dict(frame_split=8, k2=_bf16(8, 8, 40), v2=_bf16(8, 8, 40), heads=4),   # head dim 20
    dict(k2=_bf16(4, 4, 80)),                             # table width
    dict(v2=_bf16(4, 5, 40)),                             # table frames
    dict(k2=torch.zeros(4, 4, 40)),                       # float32 table
    dict(q=_bf16(8, 80, 6).transpose(1, 2)),              # not contiguous
    dict(q=_bf16(8, 480)),                                # 2-D
])
def test_relpos_mha_refuses(bad):
    with pytest.raises(ValueError):
        trelpos.check_args(**_relpos_args(**bad))
    trelpos.check_args(**_relpos_args())


def _jax_config(name):
    return getattr(jvc if name == "VideoCrafterUNetConfig" else jconfig, name)


@pytest.mark.parametrize("name", ["ModelScopeUNetConfig", "VideoCrafterUNetConfig", "VAEConfig",
                                  "CLIPTextConfig", "T2VArgs"])
def test_config_copies_match_jax(name):
    mine, theirs = getattr(tconfig, name)(), _jax_config(name)()
    assert {f.name for f in dataclasses.fields(mine)} == {f.name for f in dataclasses.fields(theirs)}
    assert dataclasses.asdict(mine) == {
        f.name: getattr(theirs, f.name) for f in dataclasses.fields(mine)}
    if hasattr(mine, "tiny"):
        assert dataclasses.asdict(mine.tiny()) == {
            f.name: getattr(theirs.tiny(), f.name) for f in dataclasses.fields(mine)}


@pytest.mark.parametrize("bad", [dict(frames=0), dict(cfg_scale=0.5), dict(steps=0),
                                 dict(sampler="nope"), dict(strength=2.0)])
def test_sanity_check_args_matches_jax(bad):
    with pytest.raises(ValueError) as mine:
        tconfig.sanity_check_args(tconfig.T2VArgs(**bad))
    with pytest.raises(ValueError) as theirs:
        jconfig.sanity_check_args(jconfig.T2VArgs(**bad))
    assert str(mine.value) == str(theirs.value)


def test_schedule_copies_match_jax():
    mine = tschedules.DiffusionSchedule.from_betas(tschedules.beta_schedule("linear", 1000, 0.00085, 0.012))
    theirs = jschedules.DiffusionSchedule.from_betas(jschedules.beta_schedule("linear", 1000, 0.00085, 0.012))
    for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    for steps in (20, 30, 7, 1000):
        ts = tschedules.make_ddim_timesteps(steps, 1000)
        np.testing.assert_array_equal(ts, jschedules.make_ddim_timesteps(steps, 1000))
        ts = np.minimum(ts, 999)
        for a, b in zip(tschedules.make_ddim_sampling_parameters(mine.alphas_cumprod, ts, 0.3),
                        jschedules.make_ddim_sampling_parameters(theirs.alphas_cumprod, ts, 0.3)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tschedules.make_ddim_timesteps(10, 100, "quad"),
                                  jschedules.make_ddim_timesteps(10, 100, "quad"))
    with pytest.raises(ValueError) as e1:
        tschedules.make_ddim_timesteps(2000, 1000)
    with pytest.raises(ValueError) as e2:
        jschedules.make_ddim_timesteps(2000, 1000)
    assert str(e1.value) == str(e2.value)


def test_seed_rules():
    assert trng.resolve_seed(42) == 42
    s = trng.resolve_seed(-1)
    assert 0 <= s < 2**31
    assert trng.batch_seed(10, 3) == 13
    a = trng.latent_noise(trng.generator(7, "cpu"), (1, 2, 3), "cpu")
    b = trng.latent_noise(trng.generator(7, "cpu"), (1, 2, 3), "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError):
        trng.generator(-1, "cpu")


def test_full_unet_parameter_count_matches_jax():
    from t2v.models.modelscope_unet import UNetSD as JUNet
    from t2v_torch.models.modelscope_unet import UNetSD

    cfg = jconfig.ModelScopeUNetConfig()
    shapes = jax.eval_shape(JUNet(cfg=cfg).init, jax.random.key(0), jnp.zeros((1, 2, 8, 8, 4)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, cfg.context_dim)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        unet = UNetSD(tconfig.ModelScopeUNetConfig())
    assert sum(p.numel() for p in unet.parameters()) == n_jax


def _functions_without_cv2_imports(module) -> dict:
    """{qualified name: AST dump} of every function of ``module``, with the
    ``import cv2`` statements and the docstrings dropped."""
    out = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.FunctionDef):
                body = [n for n in child.body
                        if not (isinstance(n, ast.Import) and n.names[0].name == "cv2")
                        and not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant))]
                out[prefix + child.name] = ast.dump(ast.Module(body=body, type_ignores=[]))
                visit(child, f"{prefix}{child.name}.")

    visit(ast.parse(inspect.getsource(module)), "")
    return out


def test_webvid_copy_matches_jax_and_imports_without_cv2():
    from t2v.data import webvid as jwebvid
    from t2v_torch.data import webvid as twebvid

    mine, theirs = _functions_without_cv2_imports(twebvid), _functions_without_cv2_imports(jwebvid)
    assert mine.keys() == theirs.keys() and len(mine) > 8
    assert [k for k in mine if mine[k] != theirs[k]] == []
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import t2v_torch.data.webvid, t2v_torch.cli.train\n"
            "t2v_torch.cli.train.build_parser()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_safetensors_reader_copy_matches_jax():
    from t2v.io import safetensors_io as jst
    from t2v_torch.io import safetensors_io as tst

    assert inspect.getsource(tst.load_safetensors) == inspect.getsource(jst.load_safetensors)
    assert {k: str(v) for k, v in tst._DTYPES.items()} == {k: str(v) for k, v in jst._DTYPES.items()}


def test_job_state_copy_matches_jax():
    from t2v.core import state as jstate
    from t2v_torch.core import state as tstate

    for name in ("JobState", "InterruptedException", "SkippedException"):
        assert inspect.getsource(getattr(tstate, name)) == inspect.getsource(getattr(jstate, name))
    job = tstate.JobState()
    job.begin_job(0, 2, 20)
    job.step_callback(5)
    job.interrupt()
    with pytest.raises(tstate.InterruptedException):
        job.step_callback(6)
    assert job.sampling_step == 6 and job.job == "Batch 1 out of 2"


def test_keyframes_copy_imports_without_pandas_and_keeps_the_evaluator():
    from t2v.pipeline import keyframes as jkf
    from t2v_torch.pipeline import keyframes as tkf

    for name in ("safe_eval", "parse_key_frames", "_sanitize", "_is_number"):
        assert inspect.getsource(getattr(tkf, name)) == inspect.getsource(getattr(jkf, name))
    code = ("import sys; sys.modules['pandas'] = None\n"
            "from t2v_torch.pipeline.keyframes import KeyFrameSeries\n"
            "w = KeyFrameSeries(8, 1, 4).inpainting_weights('0:(0), 7:(1)')\n"
            "assert abs(float(w[7]) - 1.0) < 1e-6, w\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_wrappers_take_their_function_only_for_tensors_that_need_a_gradient():
    x = torch.zeros(2, 3)
    assert not _build.needs_grad(x, None, 3)
    assert _build.needs_grad(x, x.clone().requires_grad_())
    with torch.no_grad():
        assert not _build.needs_grad(x.clone().requires_grad_())
    # CPU tensors never reach a kernel: no launch is counted, with or without gradients
    counters = (tflash.COUNTER, tflash.DKV_COUNTER, tflash.DQ_COUNTER, tfused.COUNTER,
                tfused.CROSS_COUNTER, tfused.TEMPORAL_COUNTER, trelpos.COUNTER, ttc.COUNTER)
    before = [c.count for c in counters]
    q = torch.randn(2, 8, 16, requires_grad=True)
    tflash.flash_attention(q, q, q).sum().backward()
    tfused.fused_self_mha(q, q, q, 2).sum().backward()
    assert q.grad is not None and [c.count for c in counters] == before
