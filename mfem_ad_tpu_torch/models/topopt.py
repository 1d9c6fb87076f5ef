"""MFEM ex37: density-filtered SiMPL topology optimization of a cantilever
(``mmto.FilteredSiMPL``).

The domain [0, 3] x [0, 1] is ``MakeCartesian2D(3, 1)`` refined
``ref_levels`` times: 3 2^r x 2^r square cells.  The left edge is clamped;
the load f = (0, -1) acts on the disc of radius 0.05 about (2.9, 0.5).
Spaces: the displacement H1 Q``order`` (vdim 2), the filtered density H1
Q``order`` and the latent psi L2 Q``order-1``; lambda = mu = 1, rho_0 =
1e-6, eps = 0.01, theta = 0.5; every form and integral takes the same
Gauss rule (``ir_order`` 4: 3 x 3 points).

The state and the filter each get an hp-GMG over the same meshes
(``multigrid.build_hp_hierarchy``): Q``order`` on the fine mesh, Q1 on it,
then Q1 on meshes halved down to 3 ``coarse_ny`` x ``coarse_ny`` cells.
The state hierarchy carries the design field "rho" on every level (a
scalar H1 field of the level's order on its mesh), which each design
iteration injects down (``GMG.inject_field``); the filter's is linearized
once, here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..adeval import ADEval
from ..fespace import L2, FESpace
from ..forms import LinearForm, NonlinearForm
from ..mmto import FilteredSiMPL, ParametrizedElasticity, PDEFilter
from ..multigrid import GMG, build_hp_hierarchy

LEFT = 3  # boundary attribute 4 of the Cartesian mesh: the edge x = 0
CENTER, RADIUS = (2.9, 0.5), 0.05


def load_fn(x):
    """ex37's volume force: (0, -1) on the closed disc, else 0."""
    inside = (x[0] - CENTER[0]) ** 2 + (x[1] - CENTER[1]) ** 2 <= RADIUS ** 2
    return np.stack([np.zeros_like(x[0]), -np.asarray(inside, np.float64)])


@dataclass
class Ex37:
    mesh: object
    state_space: FESpace
    filter_space: FESpace
    latent_space: FESpace
    load: torch.Tensor     # f at unit amplitude, zero at the clamped dofs
    opt: FilteredSiMPL


def build_ex37(ref_levels: int = 5, order: int = 2, *, alpha: float = 1.0,
               eps: float = 0.01, vol_frac: float = 0.5,
               rho_min: float = 1e-6, lam: float = 1.0, mu: float = 1.0,
               lin_tol: float = 1e-8, lin_maxiter: int = 2000,
               proj_tol: float = 1e-12, coarse_ny: int = 8,
               ir_order: int = 4, device="cuda",
               dtype: torch.dtype = torch.float64) -> Ex37:
    """ex37 at ``ref_levels`` refinements (ex37's default 5: 96 x 32
    cells); ``alpha`` is the step of iteration 1 (alpha_k = k alpha)."""
    if order < 2:
        raise ValueError("ex37 needs order >= 2 (the latent is L2 Q(p-1))")
    ny = 2 ** ref_levels
    n0 = min(coarse_ny, ny)
    levels = ref_levels - int(np.log2(n0)) + 1
    meshes = {}

    def mesh(n):
        if n not in meshes:
            meshes[n] = M.make_cartesian_2d(3 * n, n, sx=3.0, sy=1.0)
        return meshes[n]

    m = mesh(ny)
    latent = FESpace(m, order - 1, L2)

    def state_level(n, p):
        mm = mesh(n)
        f = NonlinearForm(FESpace(mm, p, vdim=2), device=device, dtype=dtype)
        f.add_ad_integrator(
            ParametrizedElasticity(2, FESpace(mm, p), lam, mu, 3.0, rho_min,
                                   clamp=False),
            ADEval.GRAD | ADEval.VECTOR, ir_order=ir_order)
        ess = np.zeros(mm.max_bdr_attribute())
        ess[LEFT] = 1
        f.set_essential_bc([ess])
        return f

    def filter_level(n, p):
        mm = mesh(n)
        f = NonlinearForm(FESpace(mm, p), device=device, dtype=dtype)
        fine = n == ny and p == order
        f.add_ad_integrator(PDEFilter(2, eps, latent if fine else None),
                            ADEval.VALUE | ADEval.GRAD, ir_order=ir_order)
        return f

    sforms = build_hp_hierarchy(state_level, n0, levels, order)
    state_gmg = GMG(sforms, fields=[
        {"rho": torch.full((f.spaces[0].ndof_scalar,), vol_frac,
                           dtype=dtype, device=device)} for f in sforms])
    fforms = build_hp_hierarchy(filter_level, n0, levels, order)
    filter_gmg = GMG(fforms, fields=[
        {"psi": torch.zeros(latent.ndof, dtype=dtype, device=device)}]
        + [{}] * (len(fforms) - 1))

    disp = sforms[0].spaces[0]
    b = LinearForm(disp, load_fn, ir_order=ir_order).assemble()
    b[np.asarray(sforms[0].ess_mask.cpu())] = 0.0
    load = torch.as_tensor(b, dtype=dtype, device=device)
    opt = FilteredSiMPL(state_gmg, filter_gmg, load, latent,
                        vol_frac=vol_frac, alpha=alpha, lin_tol=lin_tol,
                        lin_maxiter=lin_maxiter, proj_tol=proj_tol)
    return Ex37(m, disp, fforms[0].spaces[0], latent, load, opt)


def contrast(rho_f, space: FESpace):
    """Shares of the cells whose mean filtered density (over their
    nodes) lies below 0.01 and above 0.99."""
    edof = torch.as_tensor(np.asarray(space.edof, dtype=np.int64),
                           device=rho_f.device)
    cell = rho_f[edof].mean(dim=1)
    return float((cell < 0.01).double().mean()), float(
        (cell > 0.99).double().mean())
