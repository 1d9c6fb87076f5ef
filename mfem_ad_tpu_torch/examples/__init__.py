"""Example programs of the port:
``python -m mfem_ad_tpu_torch.examples.ex0``."""
