"""The model families (``benchmark/families/<family>.py``), found by the
config's ``family``: each resolves by its file, a family with no file is
refused by a message that names the path, and each gives the parameter
lists and operation counts that the harness computed before the families
were split out (pinned below)."""

import math
import os

import pytest

from benchmark import spec
from benchmark.reference import modelscope, text, vae, videocrafter
from benchmark.work import models

CONFIGS = {c["name"]: spec.load_json(os.path.join(spec.ROOT, c["file"]))
           for c in spec.benchmark()["configs"]}

# parameters of the UNet, the VAE and the text tower
PARAMETERS = {"modelscope_t2v_1.7b": (1_411_233_860, 83_653_863, 340_387_840),
              "videocrafter_t2v_base": (958_924_964, 83_653_863, 123_060_480)}
# operations of a CFG call at the request cells' frames (24, 16) on 32 x 32
# latents, of decoding those frames, of encoding 16 frames, of a text chunk
WORK = {"modelscope_t2v_1.7b": (24, 14_671_792_898_048, 14_932_494_778_368,
                                4_363_554_652_160, 45_127_233_536),
        "videocrafter_t2v_base": (16, 6_515_557_007_360, 9_954_996_518_912,
                                  4_363_554_652_160, 13_298_503_680)}
# the reference modules the families' parameter lists come from
SOURCES = {"modelscope": (modelscope, text.openclip_shapes),
           "videocrafter": (videocrafter, text.hfclip_shapes)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_resolves_by_its_file(name):
    cfg = CONFIGS[name]
    fam = spec.family(cfg)
    assert os.path.exists(os.path.join(spec.HERE, "families", cfg["family"] + ".py"))
    assert fam is spec.family(dict(cfg))  # loaded once
    assert fam.__file__ == os.path.join(spec.HERE, "families", cfg["family"] + ".py")
    assert set(fam.SECTIONS) <= set(cfg)
    assert (fam.UNET, fam.VAE) == (SOURCES[cfg["family"]][0], vae)


def test_a_family_without_a_file_names_the_path():
    with pytest.raises(FileNotFoundError, match="benchmark/families/cogvideox.py"):
        spec.family({"family": "cogvideox"})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parameter_lists(name):
    cfg = CONFIGS[name]
    shapes = spec.family(cfg).param_shapes(cfg)
    unet, tower = SOURCES[cfg["family"]]
    assert shapes == {"unet": unet.param_shapes(cfg["unet"]), "vae": vae.param_shapes(cfg["vae"]),
                      "text": tower(cfg["text"])}
    counts = tuple(sum(math.prod(s) for _, s in shapes[k]) for k in ("unet", "vae", "text"))
    assert counts == PARAMETERS[name]
    assert counts == tuple(cfg["parameters"][k] for k in ("unet", "vae", "text"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_work_counts(name):
    cfg = CONFIGS[name]
    frames, unet, decode, encode, chunk = WORK[name]
    assert models.unet_call(cfg, (2, frames, 32, 32, 4)) == unet
    assert models.vae_decode(cfg, frames, 32, 32) == decode
    assert models.vae_encode(cfg, 16, 32, 32) == encode
    assert models.text_chunk(cfg) == chunk
