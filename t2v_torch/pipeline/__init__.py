"""t2v_torch.pipeline — see the modules of this package."""
