"""Frozen operation and byte counts of one element-Jacobian call, from
the configuration's shapes alone: the same whatever route the program
takes, so a change of route cannot move the yardstick.

- operations: the blocked-W0 contraction and interpolation, the fewest
  any route of the program needs: nq (vdim^2 nd^2 sd^2 + vdim sd nd) FMA
  per element (2,448 at 3 x 3 points, vdim 2, Q1 in 2D; 3,794,688 at
  4^3 points, vdim 3, Q2 in 3D);
- bytes: the nde x nde matrices the call returns, written once, and the
  state, read once.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 67 TFLOP/s in float32
outside the tensor cores, 3.35 TB/s of HBM3.
"""

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}


def shapes(cfg: dict) -> dict:
    """Elements, points, vdim, space dimension, nodes and dofs of a
    configuration of Q(order) vector fields on an n^dim grid."""
    n, p, nq1 = cfg["n"], cfg["order"], cfg["quadrature_points_per_axis"]
    sd = cfg.get("dim", 2)
    return {"ne": n ** sd, "nq": nq1 ** sd, "vdim": cfg["vdim"], "sd": sd,
            "nd": (p + 1) ** sd, "ndof": cfg["vdim"] * (p * n + 1) ** sd}


def fma_per_element(s: dict) -> int:
    v, sd, nd = s["vdim"], s["sd"], s["nd"]
    return s["nq"] * (v * v * nd * nd * sd * sd + v * sd * nd)


def bytes_per_call(s: dict, dtype: str) -> int:
    nde = s["vdim"] * s["nd"]
    return ITEMSIZE[dtype] * (s["ne"] * nde * nde + s["ndof"])


def least_seconds(cfg: dict, dtype: str) -> tuple[float, str]:
    """(least seconds one call could take on the card, what bounds it)."""
    s = shapes(cfg)
    ops = 2.0 * fma_per_element(s) * s["ne"] / PEAK_FLOPS[dtype]
    mem = bytes_per_call(s, dtype) / PEAK_BYTES_PER_S
    return (ops, "operations") if ops >= mem else (mem, "bytes")
