"""t2v_torch — the PyTorch / CUDA port of the t2v text-to-video framework.

It mirrors the JAX package's module paths one for one and runs on an
NVIDIA H100 with kernels written by hand for Hopper (``t2v_torch/csrc``).
Entry points run on the card unless the caller asks for the CPU, where
every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
