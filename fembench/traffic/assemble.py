"""Traffic kind ``assemble``: back-to-back ``element_jacobians`` calls of
a neo-Hookean configuration (vector Q(order) on the n^dim grid) on the
integrator's default route, each on a state from a pool that the seed
draws on the device, u = (amp / n) N(0, 1) (larger states invert cells).

A unit is one call; the window closes on a synchronize.  The seed also
draws which calls are kept for the output check (``sample`` of them among
the calls the window is expected to hold, and always the last); the
others' outputs are dropped as the next call replaces them.  The check
compares each kept call's matrices with the plain reference's in float64:
max |A - A_ref| / max |A_ref|.  The control puts the reference in the
program's place with its contraction in TF32.
"""

from __future__ import annotations

import time

import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import NeoHookeanEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator

from harness import worst


class Traffic:
    def __init__(self, cfg: dict, params: dict, device, ref,
                 control: bool = False):
        self.cfg, self.params, self.ref = cfg, params, ref
        self.device = torch.device(device)
        self.control = control
        self.dtype = getattr(torch, cfg["precision"]["assemble"])
        n, dim = cfg["n"], cfg.get("dim", 2)
        mesh = (M.make_cartesian_2d(n, n) if dim == 2
                else M.make_cartesian_3d(n, n, n))
        fes = FESpace(mesh, cfg["order"], vdim=dim)
        self.ndof = fes.ndof
        self.ne = fes.num_elements
        self.intg = ADBlockIntegrator(
            NeoHookeanEnergy(dim, cfg["lambda"], cfg["mu"]), [fes],
            [ADEval.GRAD | ADEval.VECTOR], device=device, dtype=self.dtype)
        self.grid = None     # the reference's, built at its first use
        self.kept, self.failed, self.last = {}, 0, None
        self.slice_units = params["slice_calls"]

    def inputs(self, seed: int, seconds: float):
        """The pool of states, and the calls to keep: ``sample`` drawn
        among those ``seconds`` is expected to hold (set in ``warm``)."""
        self.kept, self.failed = {}, 0
        self.last = None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p = self.params
        self.states = torch.randn(
            (p["state_pool"], self.ndof), generator=gen, dtype=self.dtype,
            device=self.device) * (p["state_amplitude"] / self.cfg["n"])
        self.draw = torch.rand(p["sample"], generator=gen,
                               dtype=torch.float64, device=self.device)
        self.seconds = seconds

    def _grid(self):
        """The reference's grid: after the window for the check, in set-up
        only for the control, which is never timed."""
        if self.grid is None:
            self.grid = self.ref.Grid(self.cfg, self.device)
        return self.grid

    def _call(self, k: int):
        u = self.states[k % len(self.states)]
        if not self.control:
            return self.intg.element_jacobians([u])
        grid = self._grid()
        blocks = [self.ref.element_jacobians(
            grid, u, self.cfg["lambda"], self.cfg["mu"], lo,
            min(lo + grid.block, self.ne), "tf32")
            for lo in range(0, self.ne, grid.block)]
        return torch.cat(blocks)

    def warm(self):
        """Calls on every state of the pool (the first builds or loads the
        kernel), their mean time, and room in the allocator's cache for the
        kept outputs."""
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        spare = [self._call(k) for k in range(len(self.states))]
        sync()
        t0 = time.perf_counter()
        for k in range(len(self.states)):
            spare.append(self._call(k))
        sync()
        per_call = (time.perf_counter() - t0) / len(self.states)
        expected = max(1, int(self.seconds / per_call))
        self.sample = {int(v) for v in (self.draw * expected).tolist()}
        self.need_units = max(self.sample) + 1
        del spare

    def unit(self, k: int) -> float:
        A = self._call(k)
        if k in self.sample:
            self.kept[k] = A
        self.last = (k, A)
        return float(self.ne)

    def instrument(self, rec, spans):
        """Nothing to record in the window: the traced run's readers take
        the profiled slice."""

    def uninstrument(self):
        pass

    def slice(self):
        """The profiled slice: ``slice_calls`` calls on the pool's states."""
        for k in range(self.slice_units):
            A = self._call(k)
        return A

    def release(self):
        del self.intg

    def check(self, limits: dict) -> list:
        lam, mu = self.cfg["lambda"], self.cfg["mu"]
        grid = self._grid()
        err = 0.0
        outputs = dict(self.kept)
        if self.last is not None:
            outputs[self.last[0]] = self.last[1]
        for k, A in sorted(outputs.items()):
            u = self.states[k % len(self.states)]
            diff, scale = 0.0, 0.0
            for lo in range(0, self.ne, grid.block):
                hi = min(lo + grid.block, self.ne)
                R = self.ref.element_jacobians(grid, u, lam, mu, lo, hi)
                diff = worst(diff, float(
                    (A[lo:hi].to(torch.float64) - R).abs().max()))
                scale = max(scale, float(R.abs().max()))
            err = worst(err, diff / scale)
        return [("jacobian_rel", err, limits["jacobian_rel"])]
