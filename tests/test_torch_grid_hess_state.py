"""The grid-state kernel (``ops.grid_hess_state``): its route
(``ADBlockIntegrator.route_refusal("grid_state")``) and its plain version
on the CPU, and the CUDA kernel on the card.  This file imports neither
jax nor the JAX package, so its card tests also run on a machine without
them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_grid_hess_state.py

On the CPU: the plain version against the eager packed state
(``hess_state(..., sym=True)``) for the newton cell's discretisation (Q1
vdim 2 neo-Hookean, 3x3 points, float64 and float32), the obstacle's
primal hp-GMG fine level (Q3 diffusion, 5x5 points) and non-square grids;
which forms the route refuses and why (an integrator with ``closed=True``
among them: it keeps the eager closed Hessian, which the plain AD version
matches); CPU tensors keep the eager body.  On the card: the kernel
against the plain version at the newton cell's six level sizes and at the
obstacle's Q3 level, two calls bitwise equal; a closed integrator launches
nothing; one launch per level per direction of a six-level nonlinear
multigrid Newton solve, and the V-cycle graph over the re-linearized
levels equal to the eager V-cycle bitwise.

Tolerances, relative to the largest plane entry: 1e-13 in float64 (the
plain version forms x with an einsum, the eager body with the GEMM of the
table R; the kernel sums x in its own order, contracts multiply-adds into
FMAs and differentiates by hyper-dual numbers where the plain version
takes torch.func's forward-over-reverse), 1e-5 in float32 (the eager AD
body promotes some point operations to float64, the kernel does not)."""

import types

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
from mfem_ad_tpu_torch.coefficients import (
    FunctionCoefficient,
    ScalarFieldCoefficient,
)
from mfem_ad_tpu_torch.fespace import L2, FESpace
from mfem_ad_tpu_torch.forms import BlockNonlinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator, SymHess
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import grid_hess_state as ghs
from mfem_ad_tpu_torch.ops import nvcc
from mfem_ad_tpu_torch.solvers import NewtonOptions, newton

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


class _Dot(ADFunction):
    """0.5 |g|^2 through torch.dot: differentiable, but it does not trace."""

    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        return 0.5 * torch.dot(g, g)


class _Scaled(ADFunction):
    """0.5 s |g|^2 with a parameter s (a runtime field or a function)."""

    def __init__(self, s):
        super().__init__(2)
        self.add_parameter("s", s)

    def energy(self, g, p):
        return 0.5 * p["s"][0] * (g[0] * g[0] + g[1] * g[1])


def _form(mesh, order, vdim, energy, mode, ess_attr, device, dtype,
          closed=False):
    f = NonlinearForm(FESpace(mesh, order, vdim=vdim), device=device,
                      dtype=dtype)
    f.add_domain_integrator(ADBlockIntegrator(
        energy, f.spaces[0], mode, device=device, dtype=dtype,
        closed=closed))
    ess = np.zeros(mesh.max_bdr_attribute())
    ess[ess_attr] = 1
    f.set_essential_bc([ess])
    return f


def _neohookean(n, dev, dt, closed=False, ny=None):
    return _form(M.make_cartesian_2d(n, n if ny is None else ny), 1, 2,
                 NeoHookeanEnergy(2, 1.3, 0.7), VEC, 3, dev, dt, closed)


def _q3_diffusion(n, dev, dt, ny=None):
    return _form(M.make_cartesian_2d(n, n if ny is None else ny), 3, 1,
                 DiffusionEnergy(2), ADEval.GRAD, slice(None), dev, dt)


# (form, tolerance): the newton cell's discretisation in both types, the
# obstacle's Q3 level, non-square grids
PLAIN_CASES = {
    "q1_vdim2_neohookean_ad_f64": (lambda: _neohookean(4, "cpu", F64),
                                   1e-13),
    "q1_vdim2_neohookean_ad_f32": (lambda: _neohookean(4, "cpu", F32),
                                   1e-5),
    "q3_diffusion_f64": (lambda: _q3_diffusion(3, "cpu", F64), 1e-13),
    "q1_vdim2_neohookean_nonsquare": (
        lambda: _neohookean(5, "cpu", F64, ny=2), 1e-13),
    "q3_diffusion_nonsquare": (lambda: _q3_diffusion(2, "cpu", F64, ny=3),
                               1e-13),
}


def _vec(form, rng, scale=1.0):
    return torch.as_tensor(scale * rng.standard_normal(form.ndof),
                           dtype=form.dtype, device=form.device)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_is_the_eager_state(case):
    """The plain version's planes equal the eager packed state on the
    forms the route takes; on the CPU the route names the device alone
    and ``hess_state`` keeps the eager body."""
    make, tol = PLAIN_CASES[case]
    f = make()
    intg = f.integrators[0]
    u = _vec(f, np.random.default_rng(3), 0.01)
    state = f.grad_state(u)[0]
    assert isinstance(state, SymHess) and state.n == intg.n_input
    assert intg.route_refusal("grid_state") == (
        "the grid-state kernel runs on CUDA tables only")
    launches = ghs.grid_hess_state.launches
    planes = ghs.grid_hess_state_plain(intg.f, u, *intg.grid_state_operands())
    assert planes.dtype == f.dtype
    assert planes.shape == state.planes.shape
    assert _rel(planes, state.planes) <= tol
    assert torch.equal(ghs.grid_hess_state(intg.f, u,
                                           *intg.grid_state_operands()),
                       planes)
    assert ghs.grid_hess_state.launches == launches  # CPU: the plain one


CLOSED = "closed=True: hess_state takes the energy's closed Hessian"


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-13), (F32, 1e-5)])
def test_closed_keeps_the_eager_body(dtype, tol):
    """An integrator with ``closed=True`` is refused by name and keeps the
    eager closed Hessian, which the plain AD version matches."""
    f = _neohookean(4, "cpu", dtype, closed=True)
    intg = f.integrators[0]
    assert CLOSED in intg.route_refusal("grid_state")
    u = _vec(f, np.random.default_rng(5), 0.01)
    state = f.grad_state(u)[0]
    assert torch.equal(state.planes,
                       intg._hess_state_eager([u], sym=True).planes)
    planes = ghs.grid_hess_state_plain(intg.f, u, *intg.grid_state_operands())
    assert _rel(planes, state.planes) <= tol


def _mixed():
    m = M.make_cartesian_2d(3, 3)
    h1, l2 = FESpace(m, 1), FESpace(m, 0, L2)
    f = BlockNonlinearForm([h1, l2], device="cpu", dtype=F64)
    f.add_domain_integrator(ADBlockIntegrator(
        _Mixed(), [h1, l2], [ADEval.VALUE | ADEval.GRAD, ADEval.VALUE],
        device="cpu", dtype=F64))
    return f.integrators[0]


def _scalar(energy, mesh=None):
    return ADBlockIntegrator(
        energy, FESpace(mesh or M.make_cartesian_2d(3, 3), 1), ADEval.GRAD,
        device="cpu", dtype=F64)


def _band():
    intg = _neohookean(4, "cpu", F64).integrators[0]
    return intg.band_view(types.SimpleNamespace(world_size=2, rank=0))


# refused, each with the words of its reason
REFUSED = {
    "mixed_h1_l2": (_mixed, "mixed form of 2 spaces"),
    "h1t_triangles": (lambda: _scalar(DiffusionEnergy(2), M.make_cartesian_2d(
        3, 3, geom=M.TRIANGLE)), "'h1t'"),
    "hex_3d": (lambda: ADBlockIntegrator(
        DiffusionEnergy(3), FESpace(M.make_cartesian_3d(2, 2, 2), 1),
        ADEval.GRAD, device="cpu", dtype=F64), "3D grid"),
    "sharded_band": (_band, "band of a sharded form"),
    "field_parameters": (lambda: _scalar(_Scaled(ScalarFieldCoefficient(
        "s"))), "runtime field parameters (s)"),
    "element_varying_parameter": (lambda: _scalar(_Scaled(
        FunctionCoefficient(lambda x: 1.0 + x[0]))),
        "element-varying parameters or weights (s)"),
    "vector_integrand": (lambda: _scalar(_Flux()), "vector integrand"),
    "energy_does_not_trace": (lambda: _scalar(_Dot()),
                              "energy does not trace: torch.dot"),
    "closed_neohookean": (lambda: _neohookean(3, "cpu", F64, closed=True)
                          .integrators[0], CLOSED),
    "closed_diffusion": (lambda: ADBlockIntegrator(
        DiffusionEnergy(2), FESpace(M.make_cartesian_2d(3, 3), 1),
        ADEval.GRAD, device="cpu", dtype=F64, closed=True), CLOSED),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_route_refusal(case):
    """Each refused integrator names its reason."""
    make, words = REFUSED[case]
    assert words in (make().route_refusal("grid_state") or "")


def test_module_builds_nothing_without_nvcc():
    """The module imports and writes its sources without nvcc; CPU calls
    build and load no library."""
    f = NeoHookeanEnergy(2, 1.0, 1.0)
    code = adj.energy_code(f, {"lambda": 1, "mu": 1})
    src = ghs.kernel_source(code, 2, 4, 9, 2)
    assert ("ghs::launch<double, 2, 4, 9, 2, ad::HessianEntries<Energy>>"
            in src)
    assert "ghs::launch<float, 2, 4, 9, 2, ad::HessianEntries<Energy>>" in src
    with pytest.raises(ValueError, match="vdim\\*sd"):
        ghs.kernel_source(code, 1, 4, 9, 2)
    assert nvcc.library_path("grid_hess_state", src, ghs.HEADERS).startswith(
        nvcc.BUILD_DIR)
    assert src not in nvcc._LIBRARIES


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (form builder, size, dtype, tolerance): the newton cell's six level
# sizes (512 -> 16) in float64, its finest in float32, and the obstacle's
# Q3 fine level (pg2: 80 x 80)
KERNEL_CASES = [
    *[("neohookean", n, F64, 1e-13) for n in (512, 256, 128, 64, 32, 16)],
    ("neohookean", 512, F32, 1e-5),
    ("q3_diffusion", 80, F64, 1e-13),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,dtype,tol", KERNEL_CASES)
def test_kernel_is_the_plain_state(cuda, kind, n, dtype, tol):
    """The kernel's planes against the plain version and the eager body on
    a random state; two launches on the same input are bitwise equal, and
    ``hess_state`` takes the kernel."""
    f = (_neohookean(n, cuda, dtype) if kind == "neohookean"
         else _q3_diffusion(n, cuda, dtype))
    intg = f.integrators[0]
    assert intg.route_refusal("grid_state") is None
    u = _vec(f, np.random.default_rng(11), 0.1 / n)
    ops = intg.grid_state_operands()
    before = ghs.grid_hess_state.launches
    planes = ghs.grid_hess_state(intg.f, u, *ops)
    assert _rel(planes, ghs.grid_hess_state_plain(intg.f, u, *ops)) <= tol
    assert _rel(planes, intg._hess_state_eager([u], sym=True).planes) <= tol
    assert torch.equal(planes, ghs.grid_hess_state(intg.f, u, *ops))
    assert torch.equal(f.grad_state(u)[0].planes, planes)
    assert ghs.grid_hess_state.launches - before == 3


@pytest.mark.cuda
def test_closed_launches_nothing(cuda):
    """A closed integrator on the card keeps the eager closed Hessian: no
    launch, and the same planes as the eager body."""
    f = _neohookean(64, cuda, F64, closed=True)
    intg = f.integrators[0]
    assert CLOSED in intg.route_refusal("grid_state")
    u = _vec(f, np.random.default_rng(13), 0.1 / 64)
    before = ghs.grid_hess_state.launches
    planes = f.grad_state(u)[0].planes
    assert ghs.grid_hess_state.launches == before
    assert torch.equal(planes, intg._hess_state_eager([u], sym=True).planes)


@pytest.mark.cuda
def test_newton_launches_one_state_per_level(cuda):
    """A six-level nonlinear multigrid Newton solve launches the kernel
    once per level per direction (the finest level's state is the
    direction's); after it, the V-cycle graph over the re-linearized
    levels equals the eager V-cycle bitwise."""

    def level(n):
        return _neohookean(n, cuda, F64)

    gmg = GMG(build_hierarchy(level, 4, 6), nonlinear=True)
    f = gmg.forms[0]
    b = torch.where(f.ess_mask, 0.0, torch.full((f.ndof,), 0.05 / f.ndof,
                                                 dtype=F64, device=cuda))
    opts = NewtonOptions(abs_tol=0.0, rel_tol=1e-10, max_iter=3,
                         lin_solver="cg", lin_tol=1e-8, lin_maxiter=50,
                         preconditioner=gmg.as_preconditioner())
    before = ghs.grid_hess_state.launches
    res = newton(f, torch.zeros(f.ndof, dtype=F64, device=cuda), b,
                 opts=opts)
    directions = len(res.lin_iters)
    assert directions >= 2
    assert ghs.grid_hess_state.launches - before == 6 * directions
    r = torch.where(f.ess_mask, 0.0, _vec(f, np.random.default_rng(2)))
    y = gmg.vcycle(0, r)
    assert torch.equal(y, gmg._vcycle(0, r))
    assert torch.equal(gmg.vcycle(0, r), y)
