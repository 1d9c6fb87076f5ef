"""Example programs of the port: ``python -m mfem_ad_tpu_torch.examples.exN``
with N = 0 (AD function check), 1 (Poisson), 2 (minimal surface), 3
(linear elasticity), 4 (the LVPP obstacle problem, ``--dof-pg`` its
dof-level variant) or 5 (the gradient-constrained obstacle); ``topopt``
(SiMPL topology optimization) and ``template`` (a driver skeleton with
GLVis and ParaView output).  They run on the card; ``--device cpu``
runs them on the host."""
