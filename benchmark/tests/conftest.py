"""The benchmark's own tests: CPU at tiny sizes, except those marked
``card``, which skip without CUDA (decided in the ``card`` fixture)."""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402

# CPU-sized widths of the two UNet families, the VAE and the text towers
TINY_UNET = {
    "modelscope": {"in_dim": 4, "dim": 32, "y_dim": 32, "context_dim": 64, "out_dim": 4,
                   "dim_mult": [1, 2], "num_heads": 2, "head_dim": 16, "num_res_blocks": 1,
                   "attn_scales": [1.0, 0.5], "dropout": 0.1, "temporal_attention": True,
                   "temporal_attn_times": 1, "use_scale_shift_norm": False,
                   "parameterization": "eps", "num_timesteps": 1000},
    "videocrafter": {"in_channels": 4, "out_channels": 4, "model_channels": 32,
                     "num_res_blocks": 1, "attention_resolutions": [1], "channel_mult": [1, 2],
                     "num_heads": 2, "transformer_depth": 1, "context_dim": 64,
                     "kernel_size_t": 1, "padding_t": 0, "temporal_length": 4,
                     "use_relative_position": True, "num_classes": None,
                     "conditioning_key": "crossattn", "cond_stage2_key": None,
                     "parameterization": "eps", "num_timesteps": 1000, "linear_start": 0.00085,
                     "linear_end": 0.012, "scale_factor": 0.18215},
}
TINY_VAE = {"z_channels": 4, "embed_dim": 4, "in_channels": 3, "out_channels": 3, "ch": 32,
            "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [], "resolution": 256,
            "double_z": True, "scale_factor": 0.18215}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_config(config_name: str) -> dict:
    """A published configuration cut to CPU size, served in float32."""
    cfg = copy.deepcopy(spec.load_json(os.path.join(ROOT, "benchmark", "configs",
                                                    config_name + ".json")))
    cfg.update(dtype="float32", unet=copy.deepcopy(TINY_UNET[cfg["family"]]),
               vae=copy.deepcopy(TINY_VAE))
    cfg["text"] = dict(cfg["text"], width=64, layers=2, heads=2, vocab_size=1024)
    return cfg


def tiny_cell(name: str, **traffic) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json at CPU size: its config cut by
    ``tiny_config``, its traffic at 4 frames of 32x32 and 4 sampler steps, or
    training batches of 2 clips out of 6."""
    full = spec.cell(name)
    bench = spec.benchmark()
    conf = next(w["config"] for w in bench["workloads"] if w["name"] == name)
    if full.traffic["loop"] == "lora_train":
        tr = dict(full.traffic, frames=4, resolution=32, batch_size=2, clips=6)
    else:
        tr = dict(full.traffic, frames=4, height=32, width=32, steps=4, warm_steps=2)
    tr.update(traffic)
    return spec.Cell(name=name, chips=1, config=tiny_config(conf), traffic=tr, check=full.check,
                     end_to_end=full.end_to_end, per_layer=full.per_layer)
