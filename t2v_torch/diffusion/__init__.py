"""t2v_torch.diffusion — see the modules of this package."""
