"""Port parity, unstructured assembly: triangles, tets and non-affine
quads through ``mfem_ad_tpu_torch.integrator``.

Every oracle mesh is built in code, in both packages, from the same
numbers: a perturbed ``make_cartesian_2d(n, n, TRIANGLE)`` with its
structure dropped and Morton-sorted (``spatial_sort``), a Kuhn tet mesh
and a perturbed (non-affine) quad mesh, as ``tests/test_unstructured.py``
builds it.  Against ``mfem_ad_tpu`` in f64 on the CPU, relative 1e-10 for
single operations and 1e-8 for solves:

- the "h1t" dof exchange of structured triangles against the generic one
  (edof gather, transpose-gather scatter) on the same space, p = 1..3 at
  vdim 1 and 2 (gather exact, scatter 1e-14: only the sum order differs);
  ``einv`` equal to JAX's table; the scatter the adjoint of the gather;
- energy, residual, Hessian state, element Jacobians and ``hess_mult`` on
  each mesh; the pullback against JAX's generic physical-B path
  (``MFEM_AD_TPU_PULLBACK=0`` set on the JAX side only); a vector
  integrand on triangles (element-varying B); a grid-function field on a
  triangle mesh; a port integrator built from JAX's tables;
- both kernel routes' named refusals and ``auto_route`` on two-stage;
- Poisson MMS rates on triangles and tets at p = 1, 2 with JAX's
  thresholds; ``elasticity.solve(geom="tet")`` and the obstacle on tets
  at ``test_tet_obstacle_lvpp``'s size against JAX's runs; ex3's ``main``
  with ``--geom tri``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfem_ad_tpu import integrator as JI
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.ad import ADFunction as JADFunction
from mfem_ad_tpu.ad import ADVectorFunction as JVectorFunction
from mfem_ad_tpu.ad import DiffusionEnergy as JDiffusion
from mfem_ad_tpu.ad import NeoHookeanEnergy as JNeoHookean
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.coefficients import GridFunctionCoefficient as JGF
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.models import elasticity as jel
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu.models import poisson as jpoisson
from mfem_ad_tpu.norms import l2_error as jl2
from mfem_ad_tpu.pg import PGSolver as JPGSolver
from mfem_ad_tpu.pg import PGStepSizeRule
from mfem_ad_tpu_torch import integrator as PI
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.ad import ADFunction as PADFunction
from mfem_ad_tpu_torch.ad import ADVectorFunction as PVectorFunction
from mfem_ad_tpu_torch.ad import DiffusionEnergy as PDiffusion
from mfem_ad_tpu_torch.ad import NeoHookeanEnergy as PNeoHookean
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.coefficients import GridFunctionCoefficient as PGF
from mfem_ad_tpu_torch.convert import tables_from_numpy
from mfem_ad_tpu_torch.examples import ex3
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.models import elasticity as pel
from mfem_ad_tpu_torch.models import obstacle as pobs
from mfem_ad_tpu_torch.models import poisson as ppoisson
from mfem_ad_tpu_torch.norms import l2_error as pl2
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import fused_jacobian as fj
from mfem_ad_tpu_torch.pg import PGSolver as PPGSolver
from mfem_ad_tpu_torch.quadrature import SQUARE, TETRAHEDRON, TRIANGLE

F64 = torch.float64
TOL_OP = 1e-10  # single operations
TOL_SOLVE = 1e-8  # solves and trajectories
VEC = JADEval.GRAD | JADEval.VECTOR
PVEC = PADEval.GRAD | PADEval.VECTOR


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# ---------------------------------------------------------------------------
# The oracle meshes, built in both packages from the same numbers
# ---------------------------------------------------------------------------


def _unstructured(M, m, v):
    return M.Mesh(geom=m.geom, vertices=v, elements=m.elements,
                  attributes=m.attributes, bdr_elements=m.bdr_elements,
                  bdr_attributes=m.bdr_attributes, structured=None)


def _jitter(m, amp, seed):
    """Interior vertices moved by amp*h, uniform in [-1, 1]^2."""
    v = np.array(m.vertices)
    interior = ~(np.isclose(v[:, 0], 0) | np.isclose(v[:, 0], 1)
                 | np.isclose(v[:, 1], 0) | np.isclose(v[:, 1], 1))
    n = int(round(np.sqrt(m.num_vertices))) - 1
    rng = np.random.default_rng(seed)
    v[interior] += amp / n * rng.uniform(-1, 1, size=(interior.sum(), 2))
    return v


def tri_mesh(M, n=4, amp=0.15):
    """Perturbed triangles, structure dropped, Morton-sorted."""
    m = M.make_cartesian_2d(n, n, TRIANGLE)
    return M.spatial_sort(_unstructured(M, m, _jitter(m, amp, 0)))


def tet_mesh(M, n=2):
    return M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON)


def quad_mesh(M, n=4, amp=0.15):
    """Non-affine quads (``tests/test_unstructured.py``'s mesh)."""
    m = M.make_cartesian_2d(n, n, SQUARE)
    return _unstructured(M, m, _jitter(m, amp, 0))


MESHES = {"tri": tri_mesh, "tet": tet_mesh, "quad": quad_mesh}
# (mesh, order): neo-Hookean, vector, at the mesh's dimension
CASES = [("tri", 2), ("tet", 1), ("tet", 2), ("quad", 2)]


@functools.lru_cache(maxsize=None)
def _pair(kind: str, order: int, pullback: bool = True):
    """JAX and port neo-Hookean integrators on one oracle mesh, a seeded
    state and direction."""
    jm, pm = MESHES[kind](JM), MESHES[kind](PM)
    dim = jm.dim
    jf, pf = JFESpace(jm, order, vdim=dim), PFESpace(pm, order, vdim=dim)
    mp = pytest.MonkeyPatch()
    if not pullback:
        mp.setenv("MFEM_AD_TPU_PULLBACK", "0")
    try:
        ji = JI.ADBlockIntegrator(JNeoHookean(dim, 1.0, 1.0), [jf], [VEC])
    finally:
        mp.undo()
    pi = PI.ADBlockIntegrator(PNeoHookean(dim, 1.0, 1.0), [pf], [PVEC],
                              device="cpu")
    rng = np.random.default_rng(5)
    u = (0.01 / order) * rng.standard_normal(jf.ndof)
    v = rng.standard_normal(jf.ndof)
    return ji, pi, u, v


@functools.lru_cache(maxsize=None)
def _jax_ops(kind: str, order: int, pullback: bool = True):
    """The JAX integrator's results on the pair's inputs, jitted."""
    ji, _, u, v = _pair(kind, order, pullback)

    @jax.jit
    def run(u, v):
        H = ji.hess_state([u])
        return (ji.energy([u]), ji.residual([u])[0],
                ji.element_matrices(H, 0, 0), ji.hess_mult(H, [v])[0],
                ji.diagonal(H)[0])

    return tuple(np.asarray(a) for a in run(jnp.asarray(u), jnp.asarray(v)))


# ---------------------------------------------------------------------------
# Dof exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("vdim", [1, 2])
def test_h1t_exchange_matches_generic(order, vdim):
    """On one structured triangle space the strided h1t gather equals the
    generic edof gather exactly, and the h1t scatter the transpose-gather
    (1e-14: the sum order differs)."""
    fes = PFESpace(PM.make_cartesian_2d(3, 4, TRIANGLE), order, vdim=vdim)
    meta = PI._space_gridmeta(fes)
    assert meta[0] == "h1t"
    edof = torch.as_tensor(fes.edof.astype(np.int64))
    einv = torch.as_tensor(PI._edof_inverse(fes.edof, fes.ndof_scalar))
    rng = np.random.default_rng(order * 10 + vdim)
    u = _t(rng.standard_normal(fes.ndof))
    ue = PI._gather(u, meta, vdim, fes.nd, edof)
    assert torch.equal(ue, PI._gather(u, None, vdim, fes.nd, edof))
    re = _t(rng.standard_normal(tuple(ue.shape)))
    r_h1t = PI._scatter(re, meta, vdim, fes.nd, None)
    r_gen = PI._scatter(re, None, vdim, fes.nd, einv)
    assert rel(r_h1t, r_gen) <= 1e-14


@pytest.mark.parametrize("kind,order", [("tri", 2), ("tet", 2), ("quad", 2)])
def test_einv_matches_jax_and_scatter_is_the_adjoint(kind, order):
    """The transpose table equals JAX's (as a function and as the
    integrator's table), and <gather(u), re> = <u, scatter(re)>."""
    ji, pi, _, _ = _pair(kind, order)
    jf, pf = ji.spaces[0], pi.spaces[0]
    np.testing.assert_array_equal(pf.edof, jf.edof)
    einv = PI._edof_inverse(pf.edof, pf.ndof_scalar)
    np.testing.assert_array_equal(
        einv, JI._edof_inverse(np.asarray(jf.edof), jf.ndof_scalar))
    np.testing.assert_array_equal(pi.tables["einv"][0].numpy(),
                                  np.asarray(ji.tables["einv"][0]))
    meta = PI._space_gridmeta(pf)
    assert meta is None
    rng = np.random.default_rng(7)
    u = _t(rng.standard_normal(pf.ndof_scalar))
    edof = torch.as_tensor(pf.edof.astype(np.int64))
    ue = PI._gather(u, meta, 1, pf.nd, edof)
    re = _t(rng.standard_normal(tuple(ue.shape)))
    r = PI._scatter(re, meta, 1, pf.nd, torch.as_tensor(einv))
    lhs, rhs = float((ue * re).sum()), float((u * r).sum())
    assert abs(lhs - rhs) <= 1e-13 * abs(rhs)


# ---------------------------------------------------------------------------
# Assembly on each mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,order", CASES)
def test_assembly_matches_jax(kind, order):
    """Energy, residual, element Jacobians, hess_mult on the packed state
    and the diagonal against JAX's (both take the pullback)."""
    ji, pi, u, v = _pair(kind, order)
    assert pi.pullback and ji.pullback
    assert pi._gridmeta[0] is None
    e, r, A, Hv, d = _jax_ops(kind, order)
    ut, vt = _t(u), _t(v)
    assert abs(float(pi.energy([ut])) - float(e)) <= TOL_OP * abs(float(e))
    assert rel(pi.residual([ut])[0], r) <= TOL_OP
    H = pi.hess_state([ut], sym=True)
    assert rel(pi.element_matrices(H, 0, 0), A) <= TOL_OP
    assert rel(pi.element_jacobians([ut]), A) <= TOL_OP
    assert rel(pi.hess_mult(H, [vt])[0], Hv) <= TOL_OP
    assert rel(pi.diagonal(H)[0], d) <= TOL_OP
    # the pullback keeps B element-shared and the GEMM factors installed;
    # its inverse Jacobians are element-varying
    t = pi.tables
    assert t["B"][0].shape[0] == 1 and "R" in t and t["D0"]
    assert t["static"]["_invj"].shape[0] == pi.mesh.num_elements
    np.testing.assert_allclose(t["static"]["_invj"].numpy(),
                               np.asarray(ji.tables["static"]["_invj"]),
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("kind,order", [("tri", 2), ("quad", 2)])
def test_pullback_matches_jax_generic_path(kind, order):
    """The port's pullback against JAX's physical-B path
    (MFEM_AD_TPU_PULLBACK=0 on the JAX side only)."""
    ji, _, u, v = _pair(kind, order, pullback=False)
    assert not ji.pullback
    assert ji.tables["B"][0].shape[0] == ji.mesh.num_elements
    _, pi, _, _ = _pair(kind, order)
    e, r, A, Hv, _ = _jax_ops(kind, order, pullback=False)
    ut, vt = _t(u), _t(v)
    assert abs(float(pi.energy([ut])) - float(e)) <= TOL_OP * abs(float(e))
    assert rel(pi.residual([ut])[0], r) <= TOL_OP
    H = pi.hess_state([ut], sym=True)
    assert rel(pi.element_matrices(H, 0, 0), A) <= TOL_OP
    assert rel(pi.hess_mult(H, [vt])[0], Hv) <= TOL_OP


class JaxFlux(JVectorFunction):
    """F(g) = (1 + |g|^2) g + A g, A strictly upper: a nonsymmetric
    Jacobian."""

    def __init__(self):
        super().__init__(2, 2)

    def function(self, g, p):
        A = jnp.asarray([[0.0, 0.3], [0.0, 0.0]], dtype=g.dtype)
        return (1.0 + jnp.dot(g, g)) * g + A @ g


class TorchFlux(PVectorFunction):
    def __init__(self):
        super().__init__(2, 2)

    def function(self, g, p):
        A = torch.tensor([[0.0, 0.3], [0.0, 0.0]], dtype=g.dtype)
        return (1.0 + torch.dot(g, g)) * g + A @ g


def test_vector_integrand_on_triangles_element_varying_B():
    """A vector integrand takes no pullback: B is physical and varies per
    element, no GEMM factor is installed and the einsum forms serve."""
    jf = JFESpace(tri_mesh(JM), 2)
    pf = PFESpace(tri_mesh(PM), 2)
    ji = JI.ADBlockIntegrator(JaxFlux(), [jf], [JADEval.GRAD])
    pi = PI.ADBlockIntegrator(TorchFlux(), [pf], [PADEval.GRAD],
                              device="cpu")
    assert not pi.pullback
    t = pi.tables
    assert t["B"][0].shape[0] == pf.mesh.num_elements
    assert "R" not in t and "R0" not in t and not t["W0"] and not t["W"]
    rng = np.random.default_rng(9)
    u, v = 0.3 * rng.standard_normal(jf.ndof), rng.standard_normal(jf.ndof)

    @jax.jit
    def run(u, v):
        H = ji.hess_state([u])
        return (ji.residual([u])[0], H, ji.element_matrices(H, 0, 0),
                ji.hess_mult(H, [v])[0], ji.diagonal(H)[0])

    r, H, A, Hv, d = (np.asarray(a) for a in run(jnp.asarray(u),
                                                  jnp.asarray(v)))
    ut = _t(u)
    Hp = pi.hess_state([ut])
    assert rel(pi.residual([ut])[0], r) <= TOL_OP
    assert rel(Hp, H) <= TOL_OP
    assert rel(pi.element_matrices(Hp, 0, 0), A) <= TOL_OP
    assert rel(pi.hess_mult(Hp, [_t(v)])[0], Hv) <= TOL_OP
    assert rel(pi.diagonal(Hp)[0], d) <= TOL_OP


class JaxFieldEnergy(JADFunction):
    """0.5 (1 + k^2) |g|^2 with k a grid-function field."""

    def __init__(self, kspace):
        super().__init__(2)
        self.add_parameter("k", JGF(kspace, "k"))

    def energy(self, g, p):
        return 0.5 * (1.0 + p["k"][0] ** 2) * jnp.dot(g, g)


class TorchFieldEnergy(PADFunction):
    def __init__(self, kspace):
        super().__init__(2)
        self.add_parameter("k", PGF(kspace, "k"))

    def energy(self, g, p):
        return 0.5 * (1.0 + p["k"][0] ** 2) * torch.dot(g, g)


def test_grid_function_field_on_triangles():
    """A field on an unstructured P1 space, gathered by its own edof."""
    jm, pm = tri_mesh(JM), tri_mesh(PM)
    jk, pk = JFESpace(jm, 1), PFESpace(pm, 1)
    jf, pf = JFESpace(jm, 2), PFESpace(pm, 2)
    ji = JI.ADBlockIntegrator(JaxFieldEnergy(jk), [jf], [JADEval.GRAD])
    pi = PI.ADBlockIntegrator(TorchFieldEnergy(pk), [pf], [PADEval.GRAD],
                              device="cpu")
    assert pi.field_kinds["k"][4] is None  # no grid: the generic gather
    rng = np.random.default_rng(11)
    u, k = rng.standard_normal(jf.ndof), rng.standard_normal(jk.ndof)

    @jax.jit
    def run(u, k):
        f = {"k": k}
        return (ji.energy([u], f), ji.residual([u], f)[0],
                ji.element_matrices(ji.hess_state([u], f), 0, 0))

    e, r, A = (np.asarray(a) for a in run(jnp.asarray(u), jnp.asarray(k)))
    f = {"k": _t(k)}
    ut = _t(u)
    assert abs(float(pi.energy([ut], f)) - float(e)) <= TOL_OP * abs(float(e))
    assert rel(pi.residual([ut], f)[0], r) <= TOL_OP
    assert rel(pi.element_jacobians([ut], f), A) <= TOL_OP


@pytest.mark.parametrize("kind", ["tet", "quad"])
def test_port_integrator_from_jax_tables(kind):
    """``convert`` carries einv, _invj, element-varying w (the quads'; a
    Kuhn split's tets share one volume) and B across: a port integrator
    on JAX's tables gives JAX's residual and element Jacobians."""
    ji, _, u, _ = _pair(kind, 2)
    tables = tables_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ji.tables),
                               "cpu", F64)
    pf = PFESpace(MESHES[kind](PM), 2, vdim=ji.mesh.dim)
    pi = PI.ADBlockIntegrator(PNeoHookean(pf.mesh.dim, 1.0, 1.0), [pf],
                              [PVEC], device="cpu", tables=tables)
    ne = pf.mesh.num_elements
    assert pi.tables["w"].shape[0] == (ne if kind == "quad" else 1)
    assert pi.tables["static"]["_invj"].shape[0] == ne
    assert pi.tables["einv"][0].shape[0] == pf.ndof_scalar
    _, r, A, _, _ = _jax_ops(kind, 2)
    ut = _t(u)
    assert rel(pi.residual([ut])[0], r) <= TOL_OP
    assert rel(pi.element_jacobians([ut]), A) <= TOL_OP


@pytest.mark.parametrize("kind", ["tri", "tet", "quad"])
def test_kernel_routes_refuse_element_varying_geometry(kind):
    _, pi, u, _ = _pair(kind, 1 if kind == "tet" else 2)
    for why in (fj.kernel_route_refusal(pi), adj.ad_kernel_route_refusal(pi)):
        assert why.startswith("element-varying geometry (_invj")
        assert "unstructured integrators take two-stage" in why
    assert pi.auto_route() == "two_stage"
    for route in ("kernel", "kernel_ad"):
        with pytest.raises(ValueError, match="element-varying geometry"):
            pi.element_jacobians([_t(u)], route=route)


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
def test_poisson_mms_rate_on_triangles(order):
    """ex1's problem on triangles (h1t exchange, pullback): the errors
    equal JAX's and the L2 rate is above p + 0.7."""
    errs = []
    for r in (0, 1):
        _, err, _ = ppoisson.solve(order, r, n0=4, geom=TRIANGLE,
                                   device="cpu")
        _, jerr, _ = jpoisson.solve(order, r, geom=TRIANGLE, n0=4)
        assert abs(err - jerr) <= TOL_SOLVE * jerr
        errs.append(err)
    assert np.log2(errs[0] / errs[1]) > order + 0.7


def _tet_poisson_error(pkg, n, p):
    """JAX's ``tests/test_tet.py`` problem: -lap u = f on a Kuhn tet mesh,
    Dirichlet data from the exact solution, Jacobi-CG Newton."""
    M, FES, NLF, LF, Diff, l2, S = pkg

    def exact(x):
        return (np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
                * np.sin(np.pi * x[2]))

    def load(x):
        return 3 * np.pi**2 * exact(x)

    m = M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON)
    fes = FES(m, p)
    kw = {} if pkg is JPKG else {"device": "cpu"}
    nlf = NLF(fes, **kw)
    nlf.add_ad_integrator(Diff(3), JADEval.GRAD if pkg is JPKG
                          else PADEval.GRAD)
    nlf.set_essential_bc([np.ones(m.max_bdr_attribute())])
    b = LF(fes, load).assemble()
    b[np.asarray(fes.boundary_dofs())] = 0.0
    x0 = fes.project_bdr(np.zeros(fes.ndof), exact)
    opts = S.NewtonOptions(abs_tol=1e-12, max_iter=3, lin_solver="cg",
                           lin_tol=1e-14, preconditioner="jacobi")
    if pkg is JPKG:
        res = S.newton(nlf, jnp.asarray(x0), b=jnp.asarray(b), opts=opts)
    else:
        res = S.newton(nlf, _t(x0), b=_t(b), opts=opts)
    assert res.converged
    return l2(fes, np.asarray(res.x), exact)


JPKG = (JM, JFESpace, JNonlinearForm, JLinearForm, JDiffusion, jl2, JS)
PPKG = (PM, PFESpace, PNonlinearForm, PLinearForm, PDiffusion, pl2, PS)


@pytest.mark.parametrize("p,ns,min_rate", [(1, (4, 8), 1.7),
                                           (2, (2, 4), 2.6)])
def test_tet_poisson_mms_rate(p, ns, min_rate):
    """L2 rate on tets with JAX's thresholds (``tests/test_tet.py``), the
    errors equal to JAX's."""
    errs = []
    for n in ns:
        e = _tet_poisson_error(PPKG, n, p)
        assert abs(e - _tet_poisson_error(JPKG, n, p)) <= TOL_SOLVE * e
        errs.append(e)
    assert np.log2(errs[0] / errs[1]) > min_rate


def test_elasticity_tet_matches_jax():
    """ex3 on a Kuhn tet mesh (vdim 3, GRAD|VECTOR) against JAX's."""
    res, pb = pel.solve(order=1, ref_levels=0, dim=3, geom="tet",
                        lin_solver="dense", device="cpu")
    jres, _ = jel.solve(order=1, ref_levels=0, dim=3, geom="tet",
                          lin_solver="dense")
    assert res.converged and jres.converged
    assert pb.mesh.geom == TETRAHEDRON and pb.form.integrators[0].pullback
    assert rel(res.x.numpy(), jres.x) <= TOL_SOLVE


def test_obstacle_tet_matches_jax():
    """ex4's LVPP loop on tets at ``test_tet_obstacle_lvpp``'s size
    (dense inner solves) against JAX's: iterations, Newton counts, x; and
    the test's bounds."""
    runs = {}
    for name, obs, Solver, S, kw in (
            ("jax", jobs, JPGSolver, JS, {}),
            ("port", pobs, PPGSolver, PS, {"device": "cpu"})):
        pb = obs.build(order=1, ref_levels=1, n0=2, dim=3, geom="tet", **kw)
        rule = PGStepSizeRule(PGStepSizeRule.EXP, 0.1, 1e4, 2.0, 1.0)
        solver = Solver(pb.form, rule, latent_block=1,
                        latent_space=pb.latent_space,
                        newton_opts=S.NewtonOptions(abs_tol=1e-9, max_iter=20,
                                                    lin_solver="dense"),
                        max_iter=40, tol=1e-6)
        x0 = (jnp.zeros(pb.form.ndof) if name == "jax"
              else torch.zeros(pb.form.ndof, dtype=F64))
        runs[name] = (solver.solve(x0, pb.rhs), pb)
    (res, pb), (jres, _) = runs["port"], runs["jax"]
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    assert res.newton_iters == jres.newton_iters
    x = res.x.numpy()
    assert rel(x, np.asarray(jres.x)) <= TOL_SOLVE
    nu = pb.primal_space.ndof
    u = x[:nu]
    assert u.min() > -1e-8 and 0.49 < u.max() < 0.5 + 0.06
    mirror = 0.5 / (1.0 + np.exp(-0.5 * x[nu:]))
    assert mirror.min() >= 0.0 and mirror.max() <= 0.5


def test_ex3_main_on_triangles():
    res, pb = ex3.main(["--geom", "tri", "-r", "0", "--solver", "dense",
                        "--device", "cpu"])
    assert res.converged and pb.mesh.geom == TRIANGLE
    jres, _ = jel.solve(order=1, ref_levels=0, geom="tri",
                        lin_solver="dense")
    assert rel(res.x.numpy(), jres.x) <= TOL_SOLVE


def test_bench_unstructured_rows_on_cpu(monkeypatch):
    """The bench's two unstructured rows at a tiny size, with the CUDA
    event timer stubbed: the triangles of n^2 cells lose their structure
    and are Morton-sorted; both rows take two-stage and name why the AD
    route refuses."""
    from mfem_ad_tpu_torch import bench

    monkeypatch.setattr(bench, "call_ms", lambda fn, reps=20, warmup=3:
                        (fn(), 1.0)[1])
    assert bench.SWEEP_UNSTRUCTURED == ((1, 2, 512, "unstructured"),
                                        (1, 3, 16, "tet"))
    m = bench.unstructured_triangles(4)
    assert m.structured is None and m.num_elements == 32
    for order, dim, n, mesh, ne in ((1, 2, 4, "unstructured", 32),
                                    (1, 3, 2, "tet", 48)):
        row = bench.sweep_row(order, dim, n, device="cpu", mesh=mesh)
        assert row["elems"] == ne and row["route"] == "two_stage"
        assert row["jacobian"] == ne / 1e-3
        assert row["ad"] is None
        assert row["ad_refusal"].startswith("element-varying geometry")
        assert bench.format_row(row).startswith(f"| p=1 {mesh} | {dim}D |")
