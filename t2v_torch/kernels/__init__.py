"""t2v_torch.kernels — see the modules of this package."""
