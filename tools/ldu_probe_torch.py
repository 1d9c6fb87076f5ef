"""Probe of the port's lumped LDU-FGMRES direction (ex5).

    python tools/ldu_probe_torch.py                 # refs 3 and 4, GPU
    python tools/ldu_probe_torch.py 3               # one ref
    python tools/ldu_probe_torch.py --wb-only 3     # the Woodbury mode only
    python tools/ldu_probe_torch.py --device cpu --n0 10 0 1

For ex5's problem (order 2, n0 10 unless ``--n0``) at each ref: the build
time; on a GPU one saddle ``grad_mult``, ``grad_state``, a V-cycle of the
hp-GMG plain and shifted, and the lumped Schur arrays (CUDA-event
medians); then the first Newton direction (alpha 1, from zero) to
``lin_tol`` 1e-10 with the dense dual-Schur factor (up to its cap of
16,384 latent dofs) and with the Woodbury apply: FGMRES iterations, the
relative residual the direction reaches and wall time.  Each restart
cycle prints its iteration count, time and relative residual, so a run
cut by its time limit still shows how far it got, and a direction that
ends on a cycle boundary above ``lin_tol`` shows the stall exit (the
restart made < 5% progress).  A whole Woodbury direction takes minutes
to tens of minutes on the GPU; give the call an hour.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from mfem_ad_tpu_torch import solvers as PS  # noqa: E402
from mfem_ad_tpu_torch.bench import call_ms  # noqa: E402
from mfem_ad_tpu_torch.models import gradient_obstacle as go  # noqa: E402


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fgmres_restarts(fgmres):
    """``solvers._fgmres`` with a line per restart cycle: every Jacobian
    action that follows another without a preconditioner apply between
    them is the restart's true residual."""
    def run(mvs, M_ldu, r, n0, alpha, *args):
        r0 = torch.cat([r[:n0], alpha * r[n0:]])
        b0 = float(torch.linalg.vector_norm(r0))
        st = {"n": 0, "fresh": False, "t0": time.perf_counter()}

        def M(v):
            st["n"] += 1
            st["fresh"] = True
            return M_ldu(v)

        def A(v):
            out = mvs(v)
            if st["fresh"]:
                st["fresh"] = False
            else:
                rel = float(torch.linalg.vector_norm(r0 - out)) / b0
                print(f"  restart after {st['n']} FGMRES iterations, "
                      f"{time.perf_counter() - st['t0']:.1f} s: relative "
                      f"residual {rel:.3e}", flush=True)
            return out

        return fgmres(A, M, r, n0, alpha, *args)

    return run


def probe(ref: int, n0c: int, dev, wb_only: bool) -> None:
    t0 = time.perf_counter()
    pb = go.build(2, ref, n0=n0c, device=dev)
    fp = go._primal_gmg(2, ref, n0c, device=dev)
    _sync(dev)
    print(f"ref {ref} n0 {n0c}: build {time.perf_counter() - t0:.2f} s, "
          f"{pb.form.ndof} dofs", flush=True)
    x = torch.zeros(pb.form.ndof, dtype=torch.float64, device=dev)
    n0 = pb.primal_space.ndof
    fields = {"alpha": 1.0, "latent_k0": x[n0:]}
    r = PS._residual(pb.form, x, pb.rhs, fields)
    st = pb.form.grad_state(x, fields)
    if dev.type == "cuda":
        v = torch.randn(pb.form.ndof, dtype=torch.float64, device=dev)
        arrays = PS._schur_arrays(pb.form, st, 1e-6, True, lumped=True)
        sdata = fp.shift_data(arrays["dshift"])
        print(f"ref {ref}: grad_mult "
              f"{call_ms(lambda: pb.form.grad_mult(st, v)):.3f} ms, "
              f"grad_state "
              f"{call_ms(lambda: pb.form.grad_state(x, fields), reps=3):.3f}"
              f" ms, V-cycle {call_ms(lambda: fp.apply_primal(v[:n0])):.3f}"
              f" ms, shifted "
              f"{call_ms(lambda: fp.apply_primal(v[:n0], sdata)):.3f} ms, "
              f"schur arrays "
              f"{call_ms(lambda: PS._schur_arrays(pb.form, st, 1e-6, True, lumped=True), reps=3):.3f} ms",  # noqa: E501
              flush=True)
    nl = pb.form.ndof - n0
    for sd in ("auto", False):
        if sd and (wb_only or nl > PS.SIGMA_DIRECT_MAX):
            continue
        opts = PS.NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                                sigma_direct=sd)
        _sync(dev)
        t0 = time.perf_counter()
        dx, k = PS.lumped_schur_solve(pb.form, st, r, opts, fp=fp,
                                      alpha=1.0)
        _sync(dev)
        wall = time.perf_counter() - t0
        rel = float(torch.linalg.vector_norm(r - pb.form.grad_mult(st, dx))
                    / torch.linalg.vector_norm(r))
        print(f"ref {ref} sigma_direct={sd}: one direction {wall:.3f} s, "
              f"{k} FGMRES, relative residual {rel:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("refs", type=int, nargs="*", default=[3, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n0", type=int, default=10)
    ap.add_argument("--wb-only", action="store_true")
    a = ap.parse_args()
    dev = torch.device(a.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("ldu_probe_torch: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    PS._fgmres = _fgmres_restarts(PS._fgmres)
    for ref in a.refs:
        probe(ref, a.n0, dev, a.wb_only)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
