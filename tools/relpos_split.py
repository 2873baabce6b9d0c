#!/usr/bin/env python3
"""Split the rel-pos kernel's time between moving data and computing, on
the GPU.

    python3 tools/relpos_split.py

Builds ``t2v_torch/csrc/relpos_mha.cu`` five times into
``t2v_torch/_build/relpos_split/``, each copy with one part taken out by
a preprocessor switch patched into the source text: as it is; without the
output copies; without the loads after each buffer's first tile (the
compute then runs on the buffers' stale data); without both (compute
only); and without the three compute phases (data movement only). At
VideoCrafter's four temporal-attention shapes (16 frames of CFG batch 2;
8 heads of 40, 80, 160 and 160) it launches each copy under the shape's
``relpos_plan`` through the C entry, twenty times after two warm-up
launches, and prints the ms a launch by CUDA events. Only the first copy
computes the right output; the script holds that one against
``relpos_mha_plain``. The patches are anchored on source lines and fail
loudly where the source has changed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(2, 16, 1024, 8, 40), (2, 16, 256, 8, 80), (2, 16, 64, 8, 160), (2, 16, 16, 8, 160)]
# (source line, its replacement) under the switches SKIP_LOAD, SKIP_STORE, SKIP_COMPUTE
PATCHES = [
    ("      if (tile + nbuf * stride < tiles) load_tile(",
     "      if (!SKIP_LOAD && tile + nbuf * stride < tiles) load_tile("),
    ("    mbar_wait(bars + 8 * cur, (phase >> cur) & 1);",
     "    if (!SKIP_LOAD || it < nbuf) mbar_wait(bars + 8 * cur, (phase >> cur) & 1);"),
    ("      store_tile(tile, it & 1);", "      if (!SKIP_STORE) store_tile(tile, it & 1);"),
    ("    if (tables) bias_phase(std::true_type());",
     "    if (SKIP_COMPUTE) {} else if (tables) bias_phase(std::true_type());"),
    ("    for (int p = warp; p < P; p += warps) {",
     "    for (int p = warp; !SKIP_COMPUTE && p < P; p += warps) {"),
    ("    if (tables) value_phase(std::true_type());",
     "    if (SKIP_COMPUTE) {} else if (tables) value_phase(std::true_type());"),
]
VARIANTS = {"full": (0, 0, 0), "no store": (0, 1, 0), "no load": (1, 0, 0),
            "compute only": (1, 1, 0), "data only": (0, 0, 1)}


def build(out: Path) -> dict[str, ctypes.CDLL]:
    from t2v_torch.kernels import _build

    src = (_build.CSRC / "relpos_mha.cu").read_text()
    for line, patched in PATCHES:
        if src.count(line) != 1:
            raise SystemExit(f"relpos_split: source line not found once: {line!r}")
        src = src.replace(line, patched)
    out.mkdir(parents=True, exist_ok=True)
    (out / "relpos_split.cu").write_text(src)
    procs = {}
    for name, (load, store, compute) in VARIANTS.items():
        lib = out / f"{name.replace(' ', '_')}.so"
        flags = [f"-DSKIP_LOAD={load}", f"-DSKIP_STORE={store}", f"-DSKIP_COMPUTE={compute}"]
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), *flags, "-o", str(lib),
             str(out / "relpos_split.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"relpos_split: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].t2v_relpos_mha.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        libs[name].t2v_relpos_mha.restype = ctypes.c_int
    return libs


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    from t2v_torch.kernels.relpos_mha import relpos_mha_plain, relpos_plan

    if not torch.cuda.is_available():
        print("relpos_split: no CUDA device", file=sys.stderr)
        return 2
    libs = build(REPO / "t2v_torch" / "_build" / "relpos_split")
    g = torch.Generator(device="cuda").manual_seed(7)
    for b, t, n, h, d in SHAPES:
        q, k, v = (torch.randn((b * t, n, h * d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        k2, v2 = (torch.randn((t, t, d), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        o = torch.empty_like(q)
        plan = relpos_plan(b, t, n, h, d)
        stream = torch._C._cuda_getCurrentRawStream(0)

        def launch(lib):
            err = lib.t2v_relpos_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), k2.data_ptr(),
                                     v2.data_ptr(), o.data_ptr(), b, t, n, h, d, d ** -0.5,
                                     *plan.ints(), stream)
            if err:
                raise SystemExit(f"relpos_split: CUDA error {err} at launch")

        parts = []
        for name, lib in libs.items():
            for _ in range(2):
                launch(lib)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                launch(lib)
            end.record()
            torch.cuda.synchronize()
            parts.append(f"{name} {start.elapsed_time(end) / 20:.4f}")
            if name == "full":
                err = (o.float() - relpos_mha_plain(q, k, v, k2, v2, h, t).float()).abs().max()
                if err > 0.02 * relpos_mha_plain(q, k, v, k2, v2, h, t).float().abs().max():
                    raise SystemExit(f"relpos_split: the full copy disagrees by {err}")
        print(f"split {(b * t, n, h * d, h)} plan {plan.ints()}: " + ", ".join(parts)
              + " ms a launch by CUDA events", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
