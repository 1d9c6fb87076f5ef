"""Example 0: AD function check, no mesh.

Prints the AD gradient, Hessian, vector Jacobian and vector Hessian of two
small functions against hand-coded closed forms, and the max-norm errors.
Runs on the CPU in f64:

    python -m mfem_ad_tpu_torch.examples.ex0
"""

from __future__ import annotations

import numpy as np
import torch

from mfem_ad_tpu_torch.ad import ADFunction, ADVectorFunction


class MyADFunction(ADFunction):
    def energy(self, x, p):
        return torch.sin(x[0]) * torch.exp(x[1]) + x[2] ** 3


class MyADVecFunction(ADVectorFunction):
    def function(self, x, p):
        return torch.stack([torch.sin(x[0] * x[1]),
                            torch.cos(x[0] * x[1] * x[2])])


def main(verbose: bool = True) -> dict:
    """Run the checks; returns the max-norm errors by name."""
    x = np.array([0.5, 1.0, -1.0])
    xt = torch.as_tensor(x, dtype=torch.float64)
    f = MyADFunction(3)
    jac = f.gradient(xt).numpy()
    jac_ref = np.array([
        np.cos(x[0]) * np.exp(x[1]),
        np.sin(x[0]) * np.exp(x[1]),
        3.0 * x[2] ** 2,
    ])
    hess = f.hessian(xt).numpy()
    hess_ref = np.array([
        [-np.sin(x[0]) * np.exp(x[1]), np.cos(x[0]) * np.exp(x[1]), 0.0],
        [np.cos(x[0]) * np.exp(x[1]), np.sin(x[0]) * np.exp(x[1]), 0.0],
        [0.0, 0.0, 6.0 * x[2]],
    ])

    f2 = MyADVecFunction(3, 2)
    X, Y, Z = x
    jac2 = f2.gradient(xt).numpy()
    jac2_ref = np.array([
        [Y * np.cos(X * Y), X * np.cos(X * Y), 0.0],
        [-Y * Z * np.sin(X * Y * Z), -X * Z * np.sin(X * Y * Z),
         -X * Y * np.sin(X * Y * Z)],
    ])
    hess2 = f2.hessian(xt).numpy()  # [m, n, n]
    H0 = np.array([
        [-Y * Y * np.sin(X * Y), np.cos(X * Y) - X * Y * np.sin(X * Y), 0],
        [np.cos(X * Y) - X * Y * np.sin(X * Y), -X * X * np.sin(X * Y), 0],
        [0, 0, 0],
    ])
    errors = {
        "jacobian": float(np.linalg.norm(jac - jac_ref)),
        "hessian": float(np.abs(hess - hess_ref).max()),
        "jacobian2": float(np.abs(jac2 - jac2_ref).max()),
        "hessian2[0]": float(np.abs(hess2[0] - H0).max()),
    }
    if verbose:
        print("Value :", float(f(xt)))
        print("Jacobian  :", jac)
        print("Reference :", jac_ref)
        print("Hessian :\n", hess)
        print("Reference :\n", hess_ref)
        print("Jacobian2 :\n", jac2)
        print("Reference :\n", jac2_ref)
        for k, v in errors.items():
            print(f"{k} error: {v}")
    return errors


if __name__ == "__main__":
    main()
