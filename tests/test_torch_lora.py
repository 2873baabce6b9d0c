"""The port's LoRA tree, functional merge and file formats against the JAX
package's ``pipeline/lora.py`` at the tiny UNet in fp32 on the CPU, and the
port's safetensors writer and reader against the JAX package's reader and
the ``safetensors`` package.

Weights go between the packages through the converters (the JAX tree is a
flax tree with (in, out) kernels; the port's state dict carries the torch
layouts), LoRA trees through ``convert.lora_from_jax`` / ``lora_to_jax``.
Tolerance of every merged weight: atol 1e-6 (one float32 product and sum of
O(1) values on both sides).
"""

import jax
import numpy as np
import pytest
import torch

from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.io.convert import convert_unet
from t2v.io.safetensors_io import load_safetensors as j_load_safetensors
from t2v.pipeline import lora as jlora
from t2v_torch.core.config import ModelScopeUNetConfig
from t2v_torch.io import convert, safetensors_io
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.pipeline import lora as tlora
from t2v_torch.pipeline.pipeline import init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ModelScopeUNetConfig().tiny()
ATOL = 1e-6


@pytest.fixture(scope="module")
def weights():
    """(port state dict of tensors, the same weights as a JAX tree)."""
    unet = UNetSD(CFG)
    init_weights(unet, 0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.02 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    sd = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    return sd, convert_unet({k: v.numpy() for k, v in sd.items()}, JCfg().tiny())


@pytest.fixture(scope="module")
def jax_lora(weights):
    """A JAX LoRA tree with random A and B (numpy), a runtime scale on one
    module and a rank selector on another."""
    _, jparams = weights
    idx = jlora.unet_module_index(JCfg().tiny())
    tree = jlora.init_lora(jparams, idx, rank=3, key=jax.random.key(1))
    rng = np.random.default_rng(1)
    tree = {n: {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in ab.items()}
            for n, ab in tree.items()}
    names = sorted(tree)
    tree[names[0]]["scale"] = np.float32(0.5)
    tree[names[1]]["diag"] = np.array([1.0, 0.0, 2.0], np.float32)
    return tree


def _sd_of(jparams):
    return convert.from_jax_unet(jparams, CFG)


def _assert_sd_close(got, want_np, atol=ATOL):
    assert set(want_np) <= set(got)
    for k, w in want_np.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, atol=atol, err_msg=k)


def test_module_index_matches_jax(weights):
    sd, _ = weights
    mine, theirs = tlora.unet_module_index(CFG), jlora.unet_module_index(JCfg().tiny())
    assert list(mine) == list(theirs)
    for name, (pname, kind) in mine.items():
        assert kind == theirs[name][1]
        assert pname == f"{name}.weight" and pname in sd


def test_init_lora_shapes_and_zero_delta(weights):
    sd, jparams = weights
    idx = tlora.unet_module_index(CFG)
    lora = tlora.init_lora(sd, idx, 2, torch.Generator().manual_seed(1))
    theirs = jlora.init_lora(jparams, jlora.unet_module_index(JCfg().tiny()), 2, jax.random.key(1))
    assert list(lora) == list(theirs)
    for name, ab in lora.items():
        out_f, in_f = sd[idx[name][0]].shape
        assert tuple(ab["lora_A"].shape) == (in_f, 2) == theirs[name]["lora_A"].shape
        assert tuple(ab["lora_B"].shape) == (2, out_f) == theirs[name]["lora_B"].shape
        assert ab["lora_A"].dtype == torch.float32 and ab["lora_A"].requires_grad
        assert not ab["lora_B"].any() and ab["lora_B"].requires_grad
        assert idx[name][1] == "linear"
    # A ~ N(0, 1) / r: the pooled standard deviation is 1 / r
    pooled = torch.cat([ab["lora_A"].detach().ravel() for ab in lora.values()])
    assert abs(pooled.std().item() - 0.5) < 0.02
    merged = tlora.apply_lora(sd, lora, idx)
    assert merged.keys() == sd.keys()
    for k in sd:
        assert torch.equal(merged[k], sd[k])


def test_apply_lora_matches_jax_on_a_carried_tree(weights, jax_lora):
    sd, jparams = weights
    before = {k: v.clone() for k, v in sd.items()}
    want = _sd_of(jlora.apply_lora(jparams, jax_lora, jlora.unet_module_index(JCfg().tiny()),
                                   alpha=1.5))
    lora = convert.lora_from_jax(jax_lora)
    idx = tlora.unet_module_index(CFG)
    got = tlora.apply_lora(sd, lora, idx, alpha=1.5)
    _assert_sd_close(got, want)
    targets = {idx[n][0] for n in lora}
    for k in sd:
        assert torch.equal(sd[k], before[k])                 # the base is not written to
        assert (got[k] is sd[k]) == (k not in targets)        # untouched entries are the base's
    assert sum(not torch.equal(got[k], sd[k]) for k in targets) == len(targets)


def test_lora_tree_carries_to_jax_and_back(jax_lora):
    back = convert.lora_to_jax(convert.lora_from_jax(jax_lora))
    assert back.keys() == jax_lora.keys()
    for name, ab in jax_lora.items():
        assert back[name].keys() == ab.keys()
        for k, v in ab.items():
            np.testing.assert_array_equal(back[name][k], v)


def test_gradients_reach_only_a_and_b(weights, jax_lora):
    sd, _ = weights
    lora = convert.lora_from_jax({n: {k: v for k, v in ab.items() if k.startswith("lora_")}
                                  for n, ab in jax_lora.items()})
    idx = tlora.unet_module_index(CFG)
    base = {k: v.detach() for k, v in sd.items()}
    merged = tlora.apply_lora(base, lora, idx)
    loss = sum((merged[idx[n][0]] ** 2).sum() for n in lora)
    leaves = [t for ab in lora.values() for t in ab.values()]
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.abs().sum() > 0 for g in grads)
    assert all(not v.requires_grad for v in base.values())


def test_stable_lora_file_round_trip_and_merge(weights, jax_lora, tmp_path):
    sd, jparams = weights
    tree = {n: {k: v for k, v in ab.items() if k.startswith("lora_")}
            for n, ab in jax_lora.items()}
    lora = convert.lora_from_jax(tree)
    idx = tlora.unet_module_index(CFG)
    path = tlora.save_stable_lora(str(tmp_path / "mine.safetensors"), lora,
                                  metadata={"rank": 3, "step": 7})
    # the port's file, read by the JAX package's reader and by the port's own
    for reader in (j_load_safetensors, safetensors_io.load_safetensors):
        tensors, meta = reader(path)
        assert meta[tlora.METADATA_TAG] == "true" and meta["rank"] == "3" and meta["step"] == "7"
        want = jlora.lora_to_stable_sd(tree)
        assert tensors.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(tensors[k], want[k])
    assert jlora.discover_loras(str(tmp_path))[0]["lora_name"] == "mine"
    # merged from the file == merged functionally, on both sides
    merged, skipped = tlora.merge_stable_lora(sd, tensors, 0.7, idx)
    assert skipped == []
    functional = tlora.apply_lora(sd, lora, idx, alpha=0.7)
    for k in sd:
        np.testing.assert_allclose(merged[k].numpy(), functional[k].detach().numpy(), atol=ATOL)
    jmerged, jskipped = jlora.merge_stable_lora(jparams, tensors, 0.7,
                                                jlora.unet_module_index(JCfg().tiny()))
    assert jskipped == []
    _assert_sd_close(merged, _sd_of(jmerged))
    undone, _ = tlora.merge_stable_lora(merged, tensors, 0.7, idx, undo=True)
    for k in sd:
        np.testing.assert_allclose(undone[k].numpy(), sd[k].numpy(), atol=ATOL)
    # the reverse: the JAX package's file, read by the port
    theirs = jlora.save_stable_lora(str(tmp_path / "theirs.safetensors"), tree, metadata={"a": 1})
    tensors2, meta2 = safetensors_io.load_safetensors(theirs)
    assert meta2 == {tlora.METADATA_TAG: "true", "a": "1"}
    for k in tensors:
        np.testing.assert_array_equal(tensors2[k], tensors[k])


def test_lvdm_format_matches_jax(jax_lora, tmp_path):
    tree = {n: {k: v for k, v in ab.items() if k.startswith("lora_")}
            for n, ab in jax_lora.items()}
    lora = convert.lora_from_jax(tree)
    want = jlora.lora_to_lvdm_sd(tree)
    got = tlora.lora_to_lvdm_sd(lora)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    path = tlora.save_lvdm_lora(str(tmp_path / "lvdm.safetensors"), lora, metadata={"r": 3})
    tensors, meta = j_load_safetensors(path)
    assert meta == {"r": "3"} and tensors.keys() == want.keys()


def test_merge_conv_kinds_and_bias_match_jax(weights):
    """Conv2d, Conv1d and the temporal Conv3d mean-collapse, a bias delta,
    trailing singleton dims and an unknown module, as a file may carry them."""
    sd, jparams = weights
    idx = tlora.unet_module_index(CFG)
    rng = np.random.default_rng(3)
    names = {"conv2d": "input_blocks.1.0.in_layers.2", "conv1d": "input_blocks.0.1.proj_in",
             "conv3d": "input_blocks.1.0.temopral_conv.conv2.3",
             "linear": "input_blocks.1.1.transformer_blocks.0.attn1.to_q"}
    lora_sd = {}
    for kind, name in names.items():
        assert idx[name][1] == kind
        w = sd[idx[name][0]]
        cout, cin = w.shape[0], w.shape[1]
        width = {"conv2d": cin * 9, "conv3d": cin * 9, "conv1d": cin, "linear": cin}[kind]
        lora_sd[f"{name}.lora_A"] = (0.1 * rng.normal(size=(2, width))).astype(np.float32)
        lora_sd[f"{name}.lora_B"] = (0.1 * rng.normal(size=(cout, 2))).astype(np.float32)
    conv2d = names["conv2d"]
    lora_sd[f"{conv2d}.bias"] = rng.normal(size=sd[f"{conv2d}.bias"].shape).astype(np.float32)
    lora_sd[f"{names['linear']}.lora_B"] = lora_sd[f"{names['linear']}.lora_B"][:, :, None, None]
    lora_sd["not.a.module.lora_A"] = np.zeros((2, 4), np.float32)
    lora_sd["not.a.module.lora_B"] = np.zeros((4, 2), np.float32)
    got, skipped = tlora.merge_stable_lora(sd, lora_sd, 1.3, idx)
    want, jskipped = jlora.merge_stable_lora(jparams, lora_sd, 1.3,
                                             jlora.unet_module_index(JCfg().tiny()))
    assert skipped == jskipped == ["not.a.module"]
    _assert_sd_close(got, _sd_of(want))
    changed = {k for k in sd if not torch.equal(got[k], sd[k])}
    assert changed == {f"{n}.weight" for n in names.values()} | {f"{conv2d}.bias"}
    no_bias, _ = tlora.merge_stable_lora(sd, lora_sd, 1.3, idx, merge_bias=False)
    assert torch.equal(no_bias[f"{conv2d}.bias"], sd[f"{conv2d}.bias"])


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "uint8", "bool"])
def test_safetensors_writer_round_trips_through_every_reader(dtype, tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(4)
    arrays = {"b.weight": (rng.normal(size=(3, 5)) * 3).astype(dtype),
              "a.scalar": np.asarray(rng.normal() * 3).astype(dtype),
              "c.strided": (rng.normal(size=(4, 6)) * 3).astype(dtype).T}
    path = safetensors_io.save_safetensors(str(tmp_path / "w.safetensors"), arrays, {"k": "v"})
    for got, meta in (j_load_safetensors(path, float32=False),
                      safetensors_io.load_safetensors(path, float32=False),
                      (load_file(path), {"k": "v"})):
        assert meta == {"k": "v"} and got.keys() == arrays.keys()
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)
    # the port's reader is the JAX package's on a file the package wrote
    save_file({k: np.ascontiguousarray(v) for k, v in arrays.items() if v.ndim},
              str(tmp_path / "ref.safetensors"), metadata={"m": "1"})
    mine = safetensors_io.load_safetensors(str(tmp_path / "ref.safetensors"))
    theirs = j_load_safetensors(str(tmp_path / "ref.safetensors"))
    assert mine[1] == theirs[1] and mine[0].keys() == theirs[0].keys()
    for k in mine[0]:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k])


def test_torch_tensors_round_trip_with_bfloat16(tmp_path):
    tensors = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
               "f": torch.arange(6, dtype=torch.float32).reshape(2, 3).T, "s": torch.tensor(3.0)}
    path = safetensors_io.save_torch(str(tmp_path / "t.safetensors"), tensors, {"x": 1})
    got, meta = safetensors_io.load_torch(path)
    assert meta == {"x": "1"}
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)
    as_f32, _ = j_load_safetensors(path)   # bf16 widened by the JAX package's reader
    np.testing.assert_array_equal(as_f32["w"], tensors["w"].float().numpy())
