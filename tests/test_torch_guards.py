"""Guards of the PyTorch port: it imports nothing of JAX, flax or the JAX
package; its entry points refuse CUDA on a host without a card; its kernel
wrappers import on a CPU-only host and refuse what their kernels do not
take; its own copies of the JAX package's host modules agree with them.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import config as jconfig
from t2v_torch.core import config as tconfig
from t2v_torch.core import rng as trng
from t2v_torch.kernels import _build
from t2v_torch.kernels import flash_attention as tflash
from t2v_torch.kernels import fused_mha as tfused
from t2v_torch.kernels import temporal_conv as ttc

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "t2v")


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


@pytest.mark.parametrize("name", ["ModelScopeUNetConfig", "VAEConfig", "CLIPTextConfig", "T2VArgs"])
def test_config_copies_match_jax(name):
    mine, theirs = getattr(tconfig, name)(), getattr(jconfig, name)()
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
