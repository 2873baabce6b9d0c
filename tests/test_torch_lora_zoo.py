"""The LVDM LoRA zoo and LoRA discovery, the port against the JAX package:
every ``pipeline/lora_zoo.py`` function on the same LoRA trees over a tiny
VideoCrafter UNet and OpenCLIP tower, the safeloras container written by
both packages, and ``discover_loras`` on the same directory tree.

Tolerances: module orders, float16 container weights, ranks, metadata and
registered embeddings exactly; merged weights within 1e-6 (float32
products summed in another order). Containers: every byte of the tensor
table and of the data equal, and the metadata equal as a map (the
reference writer orders that map by a per-process hash, so its order
differs from run to run); each package parses the other's file.
"""

import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.io.convert import clip_module_index
from t2v.io.convert_vc import convert_vc_unet
from t2v.io.convert_vc import vc_module_index as j_vc_module_index
from t2v.models.videocrafter_unet import VideoCrafterUNetConfig as JCfg
from t2v.pipeline import lora_zoo as jz
from t2v.pipeline.lora import discover_loras as j_discover_loras
from t2v.text.clip import convert_open_clip_text
from t2v.text.encoder import EmbeddingDB as JEmbeddingDB
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import CLIPTextConfig, VideoCrafterUNetConfig
from t2v_torch.io.convert_vc import vc_module_index
from t2v_torch.io.safetensors_io import save_safetensors
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet
from t2v_torch.pipeline import lora_zoo as tz
from t2v_torch.pipeline.lora import METADATA_TAG, discover_loras, text_module_index
from t2v_torch.pipeline.pipeline import init_weights
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.encoder import EmbeddingDB
from t2v_torch.text.tokenizer import CLIPTokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoCrafterUNetConfig().tiny()
JCFG = JCfg(**dataclasses.asdict(CFG))
CLIP = dataclasses.replace(CLIPTextConfig().tiny(), width=32, vocab_size=600)
JCLIP = JClipCfg(**dataclasses.asdict(CLIP))


@pytest.fixture(scope="module")
def models():
    """(UNet state dict, OpenCLIP tower state dict), seeded."""
    unet, clip = VideoCrafterUNet(CFG), CLIPTextTransformer(CLIP)
    init_weights(unet, 0)
    init_weights(clip, 1)
    return unet.state_dict(), clip.state_dict()


def _lora(index, params, names, rank, seed):
    """A seeded LoRA tree over ``names`` (numpy for the JAX package, the
    same values as tensors for the port)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for n in names:
        d_out, d_in = params[index[n][0]].shape
        tree[n] = {"lora_A": rng.normal(size=(d_in, rank)).astype(np.float32),
                   "lora_B": rng.normal(size=(rank, d_out)).astype(np.float32)}
    return tree, {n: {k: torch.from_numpy(v) for k, v in ab.items()} for n, ab in tree.items()}


def _as_np(tree):
    return {n: {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in ab.items()}
            for n, ab in tree.items()}


def _same_tree(got, want) -> None:
    assert set(got) == set(want)
    for n in want:
        assert set(got[n]) == set(want[n])
        for k, v in want[n].items():
            np.testing.assert_allclose(np.asarray(_as_np({n: got[n]})[n][k], np.float32),
                                       np.asarray(v, np.float32), rtol=1e-6, atol=1e-6)


def _close_trees(got, want) -> None:
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat[path]), rtol=1e-6, atol=1e-6)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_tree_functions_match_jax(models):
    """``lora_module_order``, the flat list both ways, ``add_lora``,
    ``tune_lora_scale``, ``set_lora_diag``, ``effective_delta``,
    ``inspect_lora`` and ``collapse_lora``."""
    unet_sd, _ = models
    idx, jidx = vc_module_index(CFG), j_vc_module_index(JCFG)
    order = tz.lora_module_order(idx)
    assert order == jz.lora_module_order(jidx) == list(idx)
    pick = lambda name, kind: kind == "linear" and "attn2" in name
    assert tz.lora_module_order(idx, pick) == jz.lora_module_order(jidx, pick)
    names = order[::5]
    j_tree, t_tree = _lora(idx, unet_sd, names, 4, 0)
    j_new, t_new = _lora(idx, unet_sd, names[1:] + order[1:2], 4, 1)

    j_scaled, t_scaled = jz.tune_lora_scale(j_tree, 0.7), tz.tune_lora_scale(t_tree, 0.7)
    _same_tree(t_scaled, j_scaled)
    flat_j, flat_t = jz.lora_to_flat_weights(j_scaled, names), tz.lora_to_flat_weights(t_scaled,
                                                                                        names)
    assert len(flat_t) == len(flat_j) == 2 * len(names)
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == torch.float16 and b.dtype == np.float16
        np.testing.assert_array_equal(a.numpy(), b)
    conv = [w[:, :, None, None] for w in flat_j]  # conv-shaped factors squeeze
    _same_tree(tz.flat_weights_to_lora(conv, names), jz.flat_weights_to_lora(conv, names))
    _same_tree(tz.add_lora(t_scaled, t_new, 0.5, 2.0), jz.add_lora(j_scaled, j_new, 0.5, 2.0))
    diag = np.array([1.0, 0.0, 1.0, 0.5], np.float32)
    j_diag, t_diag = jz.set_lora_diag(j_scaled, diag), tz.set_lora_diag(t_scaled, diag)
    _same_tree(t_diag, j_diag)
    with pytest.raises(ValueError, match="diag shape"):
        tz.set_lora_diag(t_tree, np.ones(3))
    for n in names:
        np.testing.assert_allclose(tz.effective_delta(t_diag[n]).numpy(),
                                   jz.effective_delta(j_diag[n]), rtol=1e-6, atol=1e-6)
    got, want = tz.inspect_lora(t_tree), jz.inspect_lora(j_tree)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6)

    merged = tz.collapse_lora(unet_sd, t_diag, idx, alpha=0.3)
    want = jz.collapse_lora(convert_vc_unet(_np_sd(unet_sd), JCFG), j_diag, jidx, alpha=0.3)
    _close_trees(convert_vc_unet(_np_sd(merged), JCFG), want)
    assert all(merged[k] is unet_sd[k] for k in unet_sd
               if k.removesuffix(".weight") not in names)


def _split(path):
    """(header without its metadata, metadata map, data) of a safetensors
    file."""
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    text = raw[8 : 8 + n].decode()
    meta = json.loads(text).get("__metadata__", {})
    table = text.replace('"__metadata__":' + json.dumps(meta, separators=(",", ":")) + ",", "")
    return table, meta, raw[8 + n :]


def test_safeloras_containers_match_jax_byte_for_byte(models, tmp_path):
    """``save_all`` (UNet and text-encoder LoRAs with embeddings) and
    ``save_safeloras`` (pinned orders) from both packages; each package
    parses the other's file; ``patch_safeloras`` merges one into the same
    weights and registers the embeddings."""
    unet_sd, clip_sd = models
    idx, tidx = vc_module_index(CFG), text_module_index(CLIP)
    j_unet, t_unet = _lora(idx, unet_sd, list(idx)[:6], 4, 2)
    j_unet = jz.tune_lora_scale(j_unet, 0.5)
    t_unet = tz.tune_lora_scale(t_unet, 0.5)
    j_text, t_text = _lora(tidx, clip_sd, list(tidx), 2, 3)
    rng = np.random.default_rng(4)
    embeds = {"<cat>": rng.normal(size=(2, 32)).astype(np.float32),
              "bunny": rng.normal(size=(32,)).astype(np.float32)}
    ours = tz.save_all(t_unet, t_text, str(tmp_path / "t.safetensors"),
                       embeds={k: torch.from_numpy(v) for k, v in embeds.items()})
    theirs = jz.save_all(j_unet, j_text, str(tmp_path / "j.safetensors"), embeds=embeds)
    a, b = _split(ours), _split(theirs)
    assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
    assert len(open(ours, "rb").read()) == len(open(theirs, "rb").read())
    with pytest.raises(ValueError, match="should end with .safetensors"):
        tz.save_all(t_unet, None, str(tmp_path / "x.pt"))
    order = {"unet": list(reversed(list(t_unet)))}
    a = _split(tz.save_safeloras({"unet": (t_unet, ["Attention"])}, str(tmp_path / "t2"), order))
    b = _split(jz.save_safeloras({"unet": (j_unet, ["Attention"])}, str(tmp_path / "j2"), order))
    assert a == b

    for path in (ours, theirs):
        mine, ref = tz.parse_safeloras(path), jz.parse_safeloras(path)
        assert mine.keys() == ref.keys() == {"unet", "text_encoder"}
        for name in mine:
            (w, r, t), (wj, rj, tj) = mine[name], ref[name]
            assert r == rj and t == tj == sorted(tz.UNET_DEFAULT_TARGET_REPLACE if name == "unet"
                                                 else tz.TEXT_ENCODER_DEFAULT_TARGET_REPLACE)
            for x, y in zip(w, wj):
                np.testing.assert_array_equal(x.numpy(), y)
        e_mine, e_ref = tz.parse_safeloras_embeds(path), jz.parse_safeloras_embeds(path)
        assert e_mine.keys() == e_ref.keys() == embeds.keys()
        for k in embeds:
            np.testing.assert_array_equal(e_mine[k].numpy(), e_ref[k])
    bad = save_safetensors(str(tmp_path / "bad.safetensors"), {"x:0:up": np.ones(2, np.float16)})
    for parse in (tz.parse_safeloras, jz.parse_safeloras):
        with pytest.raises(ValueError, match="has no metadata"):
            parse(bad)

    db, jdb = EmbeddingDB(CLIPTokenizer.for_tests()), JEmbeddingDB(JTokenizer.for_tests())
    got = tz.patch_safeloras(theirs, {"unet": unet_sd, "text_encoder": clip_sd},
                             {"unet": idx, "text_encoder": tidx}, embedding_db=db, alpha=0.8)
    want = jz.patch_safeloras(
        ours, {"unet": convert_vc_unet(_np_sd(unet_sd), JCFG),
               "text_encoder": convert_open_clip_text(_np_sd(clip_sd), JCLIP)},
        {"unet": j_vc_module_index(JCFG), "text_encoder": clip_module_index(JCLIP)},
        embedding_db=jdb, alpha=0.8)
    _close_trees(convert_vc_unet(_np_sd(got["unet"]), JCFG), want["unet"])
    _close_trees(convert_open_clip_text(_np_sd(got["text_encoder"]), JCLIP),
                 want["text_encoder"])
    assert db.version == jdb.version == 2
    for token in embeds:
        ids = CLIPTokenizer.for_tests().encode(token)
        np.testing.assert_array_equal(db.find(ids, 0)[0], jdb.find(ids, 0)[0])
    assert tz.patch_safeloras(ours, {}, {}) == {}


def test_discover_loras_matches_jax(tmp_path):
    """Tagged stable-lora files anywhere below the directory, in sorted
    order; untagged files, files with no metadata and unreadable files
    are passed over. Only the header is read."""
    w = {"a.lora_A": np.ones((2, 4), np.float32), "a.lora_B": np.ones((4, 2), np.float32)}
    (tmp_path / "sub" / "deeper").mkdir(parents=True)
    save_safetensors(str(tmp_path / "b.safetensors"), w, {METADATA_TAG: "true", "rank": "2"})
    save_safetensors(str(tmp_path / "sub" / "deeper" / "a.safetensors"), w, {METADATA_TAG: "1"})
    save_safetensors(str(tmp_path / "sub" / "plain.safetensors"), w, {"other": "x"})
    save_safetensors(str(tmp_path / "sub" / "bare.safetensors"), w)
    (tmp_path / "sub" / "junk.safetensors").write_bytes(b"\x05\x00\x00\x00\x00\x00\x00\x00{{{")
    (tmp_path / "short.safetensors").write_bytes(b"\x01")
    (tmp_path / "c.pt").write_bytes(b"not safetensors")
    got, want = discover_loras(str(tmp_path)), j_discover_loras(str(tmp_path))
    assert got == want
    assert [d["lora_name"] for d in got] == ["b", "a"] and got[0]["rank"] == "2"
    assert discover_loras(str(tmp_path / "missing")) == []
