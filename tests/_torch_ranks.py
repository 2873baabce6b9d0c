"""One rank of the two-rank gloo group of ``tests/test_torch_parallel.py``.

    python tests/_torch_ranks.py RANK WORLD PORT OUT_DIR

Each rank joins the group over TCP on 127.0.0.1:PORT (float32, the CPU, one
torch thread) and runs, in this order:

  * the tiny ModelScope and VideoCrafter UNets (``seeded_unet``) on one
    input (``unet_inputs``), tensor-parallel over tp = 2 and frame-parallel
    over sp = 2, the frames gathered back;
  * ``run`` on the tiny pipelines (``tiny_pipeline``) of both families with
    dp = 2, tp = 2 and sp = 2 (``RUN_CASES``; two of them with a random
    seed, -1), writing PNG frames and ``args.txt`` under OUT_DIR/<case>/
    from rank 0;
  * ``run`` on requests that would not use the two ranks
    (``REFUSED_CASES``), each of which must raise on both.

Rank 0 saves the UNet outputs to OUT_DIR/unet.pt and the refusals'
messages to OUT_DIR/refusals.json. The test module imports the builders
below to make the same weights and inputs in its own process.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs, T2VOutputArgs  # noqa: E402
from t2v_torch.core.config import VideoCrafterUNetConfig  # noqa: E402
from t2v_torch.models.modelscope_unet import UNetSD  # noqa: E402
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet  # noqa: E402
from t2v_torch.pipeline.pipeline import ModelScopePipeline, init_weights  # noqa: E402
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline  # noqa: E402

FRAMES = 4
# (case, family, run keyword arguments, request fields beyond REQUEST)
RUN_CASES = [
    ("ms_dp", "ms", dict(dp_shards=2), {}),
    ("ms_dp_eta", "ms", dict(dp_shards=2), dict(sampler="DDIM", eta=0.5)),
    ("ms_tp", "ms", dict(tp_shards=2), {}),
    ("ms_sp", "ms", dict(sp_shards=2), {}),
    ("vc_dp", "vc", dict(dp_shards=2), {}),
    ("vc_tp", "vc", dict(tp_shards=2), {}),
    ("vc_sp", "vc", dict(sp_shards=2), {}),
    ("ms_dp_random_seed", "ms", dict(dp_shards=2), dict(seed=-1)),
    ("ms_tp_random_seed", "ms", dict(tp_shards=2), dict(seed=-1)),
]
# (case, family, run keyword arguments) of requests two ranks refuse
REFUSED_CASES = [
    ("no_shards", "ms", {}),
    ("vc_ddpm", "vc", dict(dp_shards=2, vc_sample_type="ddpm")),
    ("mesh_above_group", "ms", dict(dp_shards=2, tp_shards=2)),
]
REQUEST = dict(prompt="a cat in the forest", n_prompt="blurry", seed=11, steps=3,
               frames=FRAMES, width=32, height=32, cfg_scale=9.0, batch_count=2)


def seeded_unet(family: str) -> torch.nn.Module:
    """The tiny UNet of ``family`` ("ms" or "vc"), seeded, every leaf then
    perturbed (biases and zero-initialised gates too), float32 on the CPU."""
    unet = (UNetSD(ModelScopeUNetConfig().tiny()) if family == "ms"
            else VideoCrafterUNet(VideoCrafterUNetConfig().tiny()))
    init_weights(unet, 0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.02 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return unet.eval()


def unet_inputs():
    """(x, t, context) numpy inputs of one CFG-sized UNet call of either
    tiny family."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, FRAMES, 8, 8, 4)).astype(np.float32)
    t = np.array([981.0, 1.0], np.float32)
    ctx = rng.normal(size=(2, 77, 32)).astype(np.float32)
    return x, t, ctx


def tiny_pipeline(family: str):
    """The tiny random-weight pipeline of ``family``, its zero leaves
    perturbed so that the UNet's output is not 0."""
    pipe = (ModelScopePipeline.random_init(device="cpu") if family == "ms"
            else VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu"))
    text = pipe.text_encoder.model if family == "ms" else pipe.clip
    with torch.no_grad():
        for mod in (pipe.unet, pipe.vae, text):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)
    return pipe


def request(case_fields: dict) -> T2VArgs:
    return T2VArgs(**{**REQUEST, **case_fields})


def main(rank: int, world: int, port: int, out: Path) -> None:
    from t2v_torch.parallel import multihost
    from t2v_torch.parallel.mesh import get_mesh
    from t2v_torch.parallel.sharding import parallel_unet
    from t2v_torch.pipeline.run import run

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        outputs = {}
        with torch.no_grad():
            for family in ("ms", "vc"):
                unet = seeded_unet(family)
                x, t, ctx = (torch.from_numpy(a) for a in unet_inputs())
                with parallel_unet(unet, tp=get_mesh(tp=2).tp):
                    outputs[f"{family}_tp"] = unet(x, t, ctx)
                sp = get_mesh(sp=2).sp
                with parallel_unet(unet, sp=sp):
                    outputs[f"{family}_sp"] = sp.all_gather(unet(sp.shard(x, 1), t, ctx), 1)
        if rank == 0:
            torch.save(outputs, out / "unet.pt")
        pipes = {}
        for case, family, kwargs, fields in RUN_CASES:
            pipe = pipes.get(family) or pipes.setdefault(family, tiny_pipeline(family))
            run(request(fields), T2VOutputArgs(skip_video_creation=True), pipe=pipe,
                outdir=str(out / case), callback_interval=None, keep_in_vram=False, **kwargs)
        refusals = {}
        for case, family, kwargs in REFUSED_CASES:
            try:
                run(request({}), T2VOutputArgs(skip_video_creation=True), pipe=pipes[family],
                    outdir=str(out / case), callback_interval=None, keep_in_vram=False, **kwargs)
            except ValueError as e:
                refusals[case] = str(e)
        if rank == 0:
            (out / "refusals.json").write_text(json.dumps(refusals))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
