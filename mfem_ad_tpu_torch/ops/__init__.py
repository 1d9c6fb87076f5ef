"""Hand-written device kernels, each beside its plain PyTorch version."""
