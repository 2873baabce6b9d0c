"""Build and load the port's CUDA kernels.

Each ``t2v_torch/csrc/<name>.cu`` is compiled at first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes``. Libraries go to ``t2v_torch/_build/`` (ignored by git),
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as built. Every C entry returns
``cudaGetLastError()`` after its launch; ``check`` raises on anything but 0,
because a launch refused for its shared memory or block size never runs
and ``torch.cuda.synchronize()`` would not report it.

Nothing here runs at import: the CPU-only host imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# every csrc/<name>.cu the main path launches
KERNELS = ("temporal_conv", "flash_attention", "flash_attention_bwd", "fused_mha", "relpos_mha",
           "geglu")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclass
class LaunchCounter:
    """Plain launch count of one kernel wrapper: incremented where the
    wrapper launches its kernel, and nowhere else."""

    count: int = 0

    def hit(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str]) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns each name's
    compiler log (empty when it was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The raw handle of the current CUDA stream of ``t``'s device (without
    building a ``torch.cuda.Stream``, which costs several microseconds a
    launch)."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.get_device()))


def on_card(t) -> bool:
    """Whether the dispatch may send ``t`` to a kernel at all: it lies on a
    CUDA device. The one place the dispatch asks for the device, so that a
    CPU test can stand in for the card."""
    return t.is_cuda


def require(cond: bool, what: str) -> None:
    """Validation of a CUDA tensor handed to a kernel wrapper."""
    if not cond:
        raise ValueError(what)


def needs_grad(*tensors) -> bool:
    """Whether a wrapper must run as its ``autograd.Function``: autograd is
    recording and one of the tensors asks for a gradient."""
    import torch

    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def recompute_grads(fn, inputs, grad_out, needs):
    """Gradients of ``fn(*inputs)`` for the inputs flagged in ``needs``,
    by running ``fn`` again under autograd on detached copies: the backward
    of a kernel whose TPU counterpart also recomputes through its plain
    version. Returns one entry per input, None where none is needed."""
    import torch

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
