"""The GMG V-cycle's CUDA graphs (``multigrid.GMG.vcycle`` from level 0 on
a CUDA device) against the eager V-cycle body (``GMG._vcycle``), on the
card.  Skips where there is no CUDA device.  This file imports neither jax
nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gmg_graph.py

A replay runs the eager body's kernels on the same data, so every
comparison is bitwise: the V-cycle on the newton cell's hierarchy shape
(2D Q1 neo-Hookean, vdim 2, nonlinear, here 64^2 over 4 levels) after two
refreshes and a ``set_fine``; the shifted and plain V-cycles on the hp
hierarchy Q3 -> Q1; a GMG-CG solve (``cg`` keeps p = z across the next
preconditioner call, so a V-cycle that returned its graph's output buffer
would change the solve); and a level tensor replaced by assignment, which
must cost one capture more, not a replay on the old tensor."""

import numpy as np
import pytest
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch import solvers as S
from mfem_ad_tpu_torch.ad import DiffusionEnergy, NeoHookeanEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import NonlinearForm
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy, build_hp_hierarchy

pytestmark = pytest.mark.cuda

F64 = torch.float64
N, LEVELS = 64, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _newton_gmg(device):
    """The newton cell's hierarchy at 64^2: left edge clamped."""

    def level(n):
        m = M.make_cartesian_2d(n, n)
        f = NonlinearForm(FESpace(m, 1, vdim=2), device=device, dtype=F64)
        f.add_ad_integrator(NeoHookeanEnergy(2, 1.0, 1.0),
                            ADEval.GRAD | ADEval.VECTOR)
        ess = np.zeros(m.max_bdr_attribute())
        ess[3] = 1
        f.set_essential_bc([ess])
        return f

    return GMG(build_hierarchy(level, N // 2 ** (LEVELS - 1), LEVELS),
               nonlinear=True)


def _hp_gmg(device):
    """Diffusion on Q3@16 -> Q1@16 -> Q1@8, all boundaries essential."""

    def level(n, p):
        m = M.make_cartesian_2d(n, n)
        f = NonlinearForm(FESpace(m, p), device=device, dtype=F64)
        f.add_ad_integrator(DiffusionEnergy(2), ADEval.GRAD)
        f.set_essential_bc([np.ones(m.max_bdr_attribute())])
        return f

    return GMG(build_hp_hierarchy(level, 8, 2, 3))


def _vec(form, rng, scale=1.0):
    v = torch.as_tensor(scale * rng.standard_normal(form.ndof), dtype=F64,
                        device=form.device)
    return torch.where(form.ess_mask, 0.0, v)


def _same(gmg, b, sdata=None):
    y = gmg.vcycle(0, b, sdata)
    return torch.equal(y, gmg._vcycle(0, b, sdata))


def test_graphed_vcycle_is_the_eager_one(cuda):
    gmg = _newton_gmg(cuda)
    f = gmg.forms[0]
    rng = np.random.default_rng(1)
    for _ in range(2):
        gmg.refresh(_vec(f, rng, 0.1 / N))
        assert _same(gmg, _vec(f, rng))
    state = f.grad_state(_vec(f, rng, 0.1 / N))
    gmg.set_fine(state, f.grad_diag(state))
    assert _same(gmg, _vec(f, rng))
    assert (gmg.captures, gmg.replays, gmg.eager_calls) == (1, 3, 0)


def test_graphed_shifted_vcycle_is_the_eager_one(cuda):
    gmg = _hp_gmg(cuda)
    f = gmg.forms[0]
    rng = np.random.default_rng(2)
    for _ in range(2):
        sdata = gmg.shift_data(30.0 * _vec(f, rng).abs())
        assert _same(gmg, _vec(f, rng), sdata)
    assert _same(gmg, _vec(f, rng))
    assert (gmg.captures, gmg.replays) == (2, 3)


def test_gmg_cg_with_graphs_is_the_eager_solve(cuda):
    gmg = _newton_gmg(cuda)
    f = gmg.forms[0]
    rng = np.random.default_rng(3)
    x = _vec(f, rng, 0.1 / N)
    state = f.grad_state(x)
    gmg.newton_precond(f, x, state, {})
    b = _vec(f, rng)

    def mv(v):
        return f.grad_mult(state, v)

    xg, kg = S.cg(mv, b, M=gmg, tol=1e-10, maxiter=200)
    xe, ke = S.cg(mv, b, M=lambda r: gmg._vcycle(0, r), tol=1e-10,
                  maxiter=200)
    assert kg == ke and 0 < kg < 200
    assert torch.equal(xg, xe)
    assert gmg.captures == 1 and gmg.replays > kg


def test_replaced_level_tensor_recaptures(cuda):
    gmg = _newton_gmg(cuda)
    f = gmg.forms[0]
    b = _vec(f, np.random.default_rng(4))
    y0 = gmg.vcycle(0, b)
    gmg.diags[1] = 2.0 * gmg.diags[1]
    assert _same(gmg, b)
    assert not torch.equal(gmg.vcycle(0, b), y0)
    assert (gmg.captures, gmg.replays) == (2, 3)
