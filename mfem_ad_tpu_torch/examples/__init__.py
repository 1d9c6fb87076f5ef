"""Example programs of the port: ``python -m mfem_ad_tpu_torch.examples.exN``
with N = 0 (AD function check), 1 (Poisson), 2 (minimal surface) or 3
(linear elasticity).  ex1-ex3 run on the card; ``--device cpu`` runs them
on the host."""
