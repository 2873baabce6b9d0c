"""t2v_torch.io — see the modules of this package."""
