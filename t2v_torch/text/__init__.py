"""t2v_torch.text — see the modules of this package."""
