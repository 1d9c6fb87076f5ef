"""The grid Jacobian apply (``ops.grid_hess_mult``): its route and its
plain version on the CPU, and the CUDA kernel on the card.  This file
imports neither jax nor the JAX package, so its card tests also run on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_grid_hess_mult.py

On the CPU: which forms the route takes (structured 2D H1, one space, a
uniform Jacobian, a packed state) and why it refuses the others, and the
plain version against ``NonlinearForm.grad_mult``'s eager body and
``hess_mult`` on the forms it takes.  On the card: the kernel against the
eager body at the newton cell's discretisation (Q1 vdim 2 neo-Hookean) in
float64 and float32 and at the obstacle's primal hp-GMG levels (Q3 and Q1
diffusion), with essential dofs set; repeated applies bitwise equal; and a
graphed V-cycle with the kernel inside equal to the eager one bitwise.

Tolerances, relative to max |J v|: 1e-14 for the plain version and 1e-13
for the kernel in float64, 1e-5 in float32; both sum x, H x and the
element vectors in another order than the eager body's GEMMs (and the
kernel contracts multiply-adds into FMAs)."""

import numpy as np
import pytest
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import (
    ADFunction,
    ADVectorFunction,
    DiffusionEnergy,
    NeoHookeanEnergy,
)
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import L2, FESpace
from mfem_ad_tpu_torch.forms import BlockNonlinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator, SymHess
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy, build_hp_hierarchy
from mfem_ad_tpu_torch.ops import grid_hess_mult as ghm
from mfem_ad_tpu_torch.ops import nvcc

F64, F32 = torch.float64, torch.float32
VEC = ADEval.GRAD | ADEval.VECTOR


class _Flux(ADVectorFunction):
    """F(g) = (1 + |g|^2) g: a vector integrand."""

    def __init__(self):
        super().__init__(2, 2)

    def function(self, g, p):
        return (1.0 + torch.dot(g, g)) * g


class _Mixed(ADFunction):
    """0.5 |grad u|^2 + u psi on H1 x L2."""

    def __init__(self):
        super().__init__(4)

    def energy(self, x, p):
        return 0.5 * (x[1] * x[1] + x[2] * x[2]) + x[0] * x[3]


def _form(mesh, order, vdim, energy, mode, ess_attr, device, dtype):
    f = NonlinearForm(FESpace(mesh, order, vdim=vdim), device=device,
                      dtype=dtype)
    f.add_ad_integrator(energy, mode)
    ess = np.zeros(mesh.max_bdr_attribute())
    ess[ess_attr] = 1
    f.set_essential_bc([ess])
    return f


# accepted: the newton cell's discretisation and the obstacle's primal
# hp-GMG levels, on ragged grids (nx != ny)
ACCEPTED = {
    "q1_vdim2_neohookean": lambda dev, dt, n=5: _form(
        M.make_cartesian_2d(n, n - 1), 1, 2, NeoHookeanEnergy(2, 1.0, 1.0),
        VEC, 3, dev, dt),
    "q3_diffusion": lambda dev, dt, n=4: _form(
        M.make_cartesian_2d(n, n + 1), 3, 1, DiffusionEnergy(2),
        ADEval.GRAD, slice(None), dev, dt),
    "q1_diffusion": lambda dev, dt, n=6: _form(
        M.make_cartesian_2d(n + 1, n), 1, 1, DiffusionEnergy(2),
        ADEval.GRAD, slice(None), dev, dt),
}


def _mixed():
    m = M.make_cartesian_2d(3, 3)
    h1, l2 = FESpace(m, 1), FESpace(m, 0, L2)
    f = BlockNonlinearForm([h1, l2], device="cpu", dtype=F64)
    f.add_domain_integrator(ADBlockIntegrator(
        _Mixed(), [h1, l2], [ADEval.VALUE | ADEval.GRAD, ADEval.VALUE],
        device="cpu", dtype=F64))
    return f


# refused, each with the words of its reason
REFUSED = {
    "mixed_h1_l2": (_mixed, "mixed form of 2 spaces"),
    "h1t_triangles": (lambda: _form(
        M.make_cartesian_2d(3, 3, geom=M.TRIANGLE), 1, 1, DiffusionEnergy(2),
        ADEval.GRAD, 0, "cpu", F64), "'h1t'"),
    "hex_3d": (lambda: _form(
        M.make_cartesian_3d(2, 2, 2), 1, 1, DiffusionEnergy(3), ADEval.GRAD,
        0, "cpu", F64), "3D grid"),
    "vector_integrand": (lambda: _form(
        M.make_cartesian_2d(3, 3), 1, 1, _Flux(), ADEval.GRAD, 0, "cpu",
        F64), "full Hessian"),
}


def _vec(form, rng, scale=1.0):
    return torch.as_tensor(scale * rng.standard_normal(form.ndof),
                           dtype=form.dtype, device=form.device)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("case", sorted(ACCEPTED) + sorted(REFUSED))
def test_route(case):
    """Accepted forms: no refusal, and the plain version equals the eager
    ``grad_mult`` (mask included) and ``hess_mult`` (no mask); refused
    forms name their reason."""
    rng = np.random.default_rng(0)
    if case in REFUSED:
        make, words = REFUSED[case]
        f = make()
        state = f.grad_state(_vec(f, rng, 0.01))
        assert words in (ghm.route_refusal(f.integrators[0], state[0]) or "")
        return
    f = ACCEPTED[case]("cpu", F64)
    intg = f.integrators[0]
    state = f.grad_state(_vec(f, rng, 0.02))
    assert isinstance(state[0], SymHess)
    assert ghm.route_refusal(intg, state[0]) is None
    v = _vec(f, rng)
    y = ghm.grid_grad_mult(intg, state[0], v, f.ess_mask)
    assert _rel(y, f.grad_mult(state, v)) <= 1e-14
    assert torch.equal(y[f.ess_mask], v[f.ess_mask])
    assert _rel(ghm.grid_grad_mult(intg, state[0], v),
                intg.hess_mult(state[0], [v])[0]) <= 1e-14
    assert intg.eager_cuda_applies == 0  # CPU applies are not counted


def test_module_builds_nothing_without_nvcc():
    """The module imports and writes its sources without nvcc; CPU calls
    build and load no library and launch nothing."""
    src = ghm.kernel_source(2, 4, 9, 2)
    assert "ghm::launch<double, 2, 4, 9, 2>" in src
    assert "ghm::launch<float, 2, 4, 9, 2>" in src
    assert nvcc.library_path("grid_hess_mult", src, ghm.HEADERS).startswith(
        nvcc.BUILD_DIR)
    f = ACCEPTED["q1_diffusion"]("cpu", F64)
    state = f.grad_state(torch.zeros(f.ndof, dtype=F64))
    launches = ghm.grid_grad_mult.launches
    ghm.grid_grad_mult(f.integrators[0], state[0], torch.ones(f.ndof,
                                                              dtype=F64))
    assert ghm.grid_grad_mult.launches == launches
    assert src not in nvcc._LIBRARIES


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (case, dtype, size, tolerance): the newton cell's discretisation at 64^2
# in both types, the obstacle's primal levels
KERNEL_CASES = [
    ("q1_vdim2_neohookean", F64, 64, 1e-13),
    ("q1_vdim2_neohookean", F32, 64, 1e-5),
    ("q3_diffusion", F64, 20, 1e-13),
    ("q1_diffusion", F64, 40, 1e-13),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,n,tol", KERNEL_CASES)
def test_kernel_is_the_eager_apply(cuda, case, dtype, n, tol):
    """The kernel's grad_mult and hess_mult on a random state and random
    vectors, essential dofs set, against the eager body on the card; two
    calls on the same input are bitwise equal."""
    rng = np.random.default_rng(5)
    f = ACCEPTED[case](cuda, dtype, n)
    intg, ess = f.integrators[0], f.ess_mask
    state = f.grad_state(_vec(f, rng, 0.1 / n))
    assert ghm.route_refusal(intg, state[0]) is None
    before = ghm.grid_grad_mult.launches
    for _ in range(3):
        v = _vec(f, rng)
        y = f.grad_mult(state, v)
        u = torch.where(ess, 0.0, v)
        ref = torch.where(ess, v, intg._hess_mult_eager(state[0], [u])[0])
        assert _rel(y, ref) <= tol
        assert torch.equal(y, f.grad_mult(state, v))
        assert _rel(intg.hess_mult(state[0], [v])[0],
                    intg._hess_mult_eager(state[0], [v])[0]) <= tol
    assert ghm.grid_grad_mult.launches - before == 9
    assert intg.eager_cuda_applies == 0


@pytest.mark.cuda
def test_graphed_vcycle_takes_the_kernel(cuda):
    """The newton cell's hierarchy shape and the obstacle's hp hierarchy:
    every level's operator takes the kernel, in the eager V-cycle and in
    the captured graph, and a replay equals the eager V-cycle bitwise."""

    def newton_level(n):
        return _form(M.make_cartesian_2d(n, n), 1, 2,
                     NeoHookeanEnergy(2, 1.0, 1.0), VEC, 3, cuda, F64)

    def hp_level(n, p):
        m = M.make_cartesian_2d(n, n)
        return _form(m, p, 1, DiffusionEnergy(2), ADEval.GRAD, slice(None),
                     cuda, F64)

    rng = np.random.default_rng(7)
    for gmg in (GMG(build_hierarchy(newton_level, 8, 4), nonlinear=True),
                GMG(build_hp_hierarchy(hp_level, 8, 2, 3))):
        f = gmg.forms[0]
        gmg.refresh(_vec(f, rng, 0.001))
        b = torch.where(f.ess_mask, 0.0, _vec(f, rng))
        before = ghm.grid_grad_mult.launches
        y = gmg.vcycle(0, b)
        assert ghm.grid_grad_mult.launches > before  # warm-up and capture
        assert torch.equal(y, gmg._vcycle(0, b))
        assert torch.equal(gmg.vcycle(0, b), y)
        assert gmg.captures == 1 and gmg.replays == 2
        assert all(g.integrators[0].eager_cuda_applies == 0
                   for g in gmg.forms)
