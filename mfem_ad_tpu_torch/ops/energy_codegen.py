"""Straight-line C++ from a Python point energy.

``trace_energy(f, param_sizes)`` calls ``f.energy(x, p)`` once with symbolic
scalars in place of tensors and records every operation as one line of
static single assignment:

    template <typename T>
    AD_HD T energy(const T* x, const T* p) {
      using S = typename ad::scalar_of<T>::type;
      const T t0 = (x[0] * x[0]);
      ...
      return t7;
    }

``x`` holds the ``n_input`` point inputs, ``p`` the per-point parameters
concatenated in sorted name order.  ``T`` is a plain float or double (the
value) or a nested dual number of ``csrc/ad_jacobian.cuh`` (value, first
and second derivatives), so the one function gives the Hessian that the
element-Jacobian kernel contracts.

The energy sees ``x`` as an indexable of length ``n_input`` and ``p`` as a
dict of name -> indexable of ``k`` values with ``.shape == (k,)``.  The
symbolic scalar supports ``+ - * /``, unary ``-``, ``abs``, ``**`` with a
constant exponent, comparisons (``< <= > >=``) and, through
``__torch_function__``, ``torch.log exp sqrt sin cos tanh abs where``
(``admax``/``admin``), all mixed with Python numbers and 0-d tensors.
Indexables also take slices and elementwise arithmetic.  Anything else
(``torch.dot``, a reshape, a branch on a traced value, ``math.*``) raises
``UnsupportedEnergy`` naming the operation: the same restriction the JAX
package's fused kernel places on energies (scalar-unrolled, elementwise),
which every built-in energy meets.
"""

from __future__ import annotations

import math
import numbers
import weakref
from dataclasses import dataclass

import torch


class UnsupportedEnergy(ValueError):
    """The energy uses an operation the code generator does not emit."""


@dataclass(frozen=True)
class EnergyCode:
    """A traced energy: the C++ function ``name`` and its operand sizes."""

    source: str
    name: str
    n_input: int
    param_sizes: tuple  # ((name, k), ...) in the order of ``p``
    n_params: int
    n_ops: int


def _lit(c: float) -> str:
    if not math.isfinite(c):
        raise UnsupportedEnergy(f"non-finite constant {c}")
    return f"S({float(c).hex()})"


class _Trace:
    def __init__(self):
        self.lines: list[tuple[str, str, tuple]] = []  # (name, line, deps)
        self.memo: dict[str, str] = {}

    def emit(self, kind: str, expr: str, *deps) -> str:
        """The name of ``expr`` (one line per distinct expression);
        ``deps`` are the traced values it reads."""
        name = self.memo.get(expr)
        if name is None:
            name = ("t" if kind == "T" else "c") + str(len(self.lines))
            self.lines.append((name, f"  const {kind} {name} = {expr};",
                               tuple(d.name for d in deps
                                     if isinstance(d, (Sym, SymBool)))))
            self.memo[expr] = name
        return name

    def live_lines(self, roots) -> list[str]:
        """The lines the values named in ``roots`` depend on, in order."""
        deps = {name: d for name, _, d in self.lines}
        live, todo = set(), list(roots)
        while todo:
            name = todo.pop()
            if name in deps and name not in live:
                live.add(name)
                todo.extend(deps[name])
        return [line for name, line, _ in self.lines if name in live]


def _const(v):
    """A Python float for a number or a one-value tensor, else None."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise UnsupportedEnergy(
                f"a tensor of shape {tuple(v.shape)} inside the energy")
        return float(v.reshape(()))
    return None


def _operand(v):
    """(C++ text, constant value or None) of a scalar operand."""
    if isinstance(v, Sym):
        return v.name, None
    c = _const(v)
    if c is None:
        raise UnsupportedEnergy(f"an operand of type {type(v).__name__}")
    return _lit(c), c


def _trace_of(*vals):
    for v in vals:
        if isinstance(v, (Sym, SymBool)):
            return v.trace
    return None


_FOLD = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}


def _binary(op: str, a, b):
    if isinstance(a, SymVec) or isinstance(b, SymVec):
        return SymVec.elementwise(lambda u, v: _binary(op, u, v), a, b)
    tr = _trace_of(a, b)
    ea, ca = _operand(a)
    eb, cb = _operand(b)
    if tr is None:
        return _FOLD[op](ca, cb)
    # exact identities only: x + 0, x - 0, x * 1, x / 1
    if cb == 0.0 and op in "+-" or cb == 1.0 and op in "*/":
        return a
    if ca == 0.0 and op == "+" or ca == 1.0 and op == "*":
        return b
    return Sym(tr, tr.emit("T", f"({ea} {op} {eb})", a, b))


def _compare(op: str, a, b):
    tr = _trace_of(a, b)
    ea, ca = _operand(a)
    eb, cb = _operand(b)
    if tr is None:
        return {"<": ca < cb, "<=": ca <= cb, ">": ca > cb,
                ">=": ca >= cb}[op]
    return SymBool(tr, tr.emit(
        "bool", f"(ad::value({ea}) {op} ad::value({eb}))", a, b))


def _unary(fn: str, a):
    if isinstance(a, SymVec):
        return SymVec([_unary(fn, v) for v in a.items])
    if not isinstance(a, Sym):
        c = _const(a)
        if c is None:
            raise UnsupportedEnergy(f"{fn} of {type(a).__name__}")
        return {"neg": lambda: -c, "abs": lambda: abs(c),
                "log": lambda: math.log(c), "exp": lambda: math.exp(c),
                "sqrt": lambda: math.sqrt(c), "sin": lambda: math.sin(c),
                "cos": lambda: math.cos(c),
                "tanh": lambda: math.tanh(c)}[fn]()
    expr = f"(-{a.name})" if fn == "neg" else f"ad::{fn}({a.name})"
    return Sym(a.trace, a.trace.emit("T", expr, a))


def _pow(a, b):
    if isinstance(a, SymVec):
        return SymVec([_pow(v, b) for v in a.items])
    if isinstance(b, (Sym, SymVec)):
        raise UnsupportedEnergy("pow with a traced exponent")
    c = _const(b)
    if c is None:
        raise UnsupportedEnergy(f"pow with exponent {type(b).__name__}")
    if not isinstance(a, Sym):
        return _const(a) ** c
    if c == 1.0:
        return a
    if c == 2.0:
        return _binary("*", a, a)
    return Sym(a.trace, a.trace.emit("T", f"ad::pow({a.name}, {_lit(c)})",
                                     a))


def _where(cond, a, b):
    if isinstance(cond, bool) or (
            isinstance(cond, torch.Tensor) and cond.numel() == 1):
        return a if bool(cond) else b
    if not isinstance(cond, SymBool):
        raise UnsupportedEnergy(f"where on a {type(cond).__name__} condition")
    ea, _ = _operand(a)
    eb, _ = _operand(b)
    return Sym(cond.trace, cond.trace.emit(
        "T", f"({cond.name} ? T({ea}) : T({eb}))", cond, a, b))


_TORCH = {  # the names torch passes for functions and Tensor operators
    "add": lambda a, b: _binary("+", a, b),
    "sub": lambda a, b: _binary("-", a, b),
    "mul": lambda a, b: _binary("*", a, b),
    "div": lambda a, b: _binary("/", a, b),
    "pow": _pow,
    "neg": lambda a: _unary("neg", a),
    "abs": lambda a: _unary("abs", a),
    "log": lambda a: _unary("log", a),
    "exp": lambda a: _unary("exp", a),
    "sqrt": lambda a: _unary("sqrt", a),
    "sin": lambda a: _unary("sin", a),
    "cos": lambda a: _unary("cos", a),
    "tanh": lambda a: _unary("tanh", a),
    "gt": lambda a, b: _compare(">", a, b),
    "ge": lambda a, b: _compare(">=", a, b),
    "lt": lambda a, b: _compare("<", a, b),
    "le": lambda a, b: _compare("<=", a, b),
    "where": _where,
}


class _Traced:
    """Shared ``__torch_function__`` of the symbolic types."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        handler = _TORCH.get(name)
        if handler is None or kwargs:
            raise UnsupportedEnergy(
                f"torch.{name}" + (f" with keywords {sorted(kwargs)}"
                                   if kwargs and handler else ""))
        return handler(*args)

    def __bool__(self):
        raise UnsupportedEnergy("a Python branch on a traced value")

    def __float__(self):
        raise UnsupportedEnergy("conversion of a traced value to a float "
                                "(math.* or float())")

    __int__ = __index__ = __float__


class SymBool(_Traced):
    """A traced comparison, usable as ``torch.where``'s condition."""

    def __init__(self, trace: _Trace, name: str):
        self.trace = trace
        self.name = name


class _Arith(_Traced):
    """Arithmetic of traced scalars and of indexables (elementwise)."""

    def __add__(self, o):
        return _binary("+", self, o)

    def __radd__(self, o):
        return _binary("+", o, self)

    def __sub__(self, o):
        return _binary("-", self, o)

    def __rsub__(self, o):
        return _binary("-", o, self)

    def __mul__(self, o):
        return _binary("*", self, o)

    def __rmul__(self, o):
        return _binary("*", o, self)

    def __truediv__(self, o):
        return _binary("/", self, o)

    def __rtruediv__(self, o):
        return _binary("/", o, self)

    def __pow__(self, o):
        return _pow(self, o)

    def __rpow__(self, o):
        raise UnsupportedEnergy("pow with a traced exponent")

    def __neg__(self):
        return _unary("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _unary("abs", self)


class Sym(_Arith):
    """A traced scalar: the C++ expression ``name`` of type T."""

    def __init__(self, trace: _Trace, name: str):
        self.trace = trace
        self.name = name

    def __gt__(self, o):
        return _compare(">", self, o)

    def __ge__(self, o):
        return _compare(">=", self, o)

    def __lt__(self, o):
        return _compare("<", self, o)

    def __le__(self, o):
        return _compare("<=", self, o)

    def __eq__(self, o):
        raise UnsupportedEnergy("== on a traced value")

    __ne__ = __eq__
    __hash__ = None


class SymVec(_Arith):
    """An indexable of traced scalars (or constants) with ``.shape``."""

    dtype = None  # lets torch.zeros((), dtype=x.dtype, ...) trace
    device = None
    ndim = 1

    def __init__(self, items):
        self.items = list(items)

    @property
    def shape(self):
        return (len(self.items),)

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return SymVec(self.items[i])
        if isinstance(i, numbers.Integral):
            return self.items[i]
        raise UnsupportedEnergy(f"indexing with {type(i).__name__}")

    @staticmethod
    def elementwise(fn, a, b):
        n = len(a) if isinstance(a, SymVec) else len(b)
        for v in (a, b):
            if isinstance(v, SymVec) and len(v) != n:
                raise UnsupportedEnergy(
                    f"elementwise op on lengths {len(a)} and {len(b)}")
        av = a.items if isinstance(a, SymVec) else [a] * n
        bv = b.items if isinstance(b, SymVec) else [b] * n
        return SymVec(fn(u, v) for u, v in zip(av, bv))


def _traced_call(fn, n: int, param_sizes: dict):
    """Call ``fn(x, p)`` on symbolic inputs: (its result, the trace, the
    parameter sizes in the order of ``p``, the parameter count)."""
    tr = _Trace()
    x = SymVec(Sym(tr, f"x[{i}]") for i in range(n))
    p, off = {}, 0
    sizes = tuple((k, int(param_sizes[k])) for k in sorted(param_sizes))
    for k, size in sizes:
        p[k] = SymVec(Sym(tr, f"p[{off + i}]") for i in range(size))
        off += size
    try:
        out = fn(x, p)
    except UnsupportedEnergy:
        raise
    except (TypeError, AttributeError, KeyError, IndexError,
            NotImplementedError) as e:
        raise UnsupportedEnergy(f"{type(e).__name__}: {e}") from e
    return out, tr, sizes, off


def _scalar(out, what: str) -> str:
    """The C++ name of a traced scalar, or the literal of a constant."""
    if isinstance(out, Sym):
        return out.name
    if isinstance(out, (SymVec, SymBool)):
        raise UnsupportedEnergy(
            f"{what} is a {type(out).__name__}, not a scalar")
    return f"T({_operand(out)[0]})"


def trace_energy(f, param_sizes: dict, name: str = "energy") -> EnergyCode:
    """Trace ``f.energy`` into the C++ template function ``name``.

    Args:
        f: an ``ADFunction`` (``n_input`` and ``energy(x, p)``).
        param_sizes: parameter name -> values per point (k).
        name: the C++ function's name.

    Raises:
        UnsupportedEnergy: the energy uses an operation that is not emitted.
    """
    n = int(f.n_input)
    out, tr, sizes, n_params = _traced_call(f.energy, n, param_sizes)
    ret = _scalar(out, "the energy's value")
    lines = tr.live_lines([ret])
    body = "\n".join(lines)
    source = (
        "template <typename T>\n"
        f"AD_HD T {name}(const T* x, const T* p) {{\n"
        "  using S = typename ad::scalar_of<T>::type;\n"
        f"{body}\n"
        f"  return {ret};\n"
        "}\n"
    )
    return EnergyCode(source=source, name=name, n_input=n,
                      param_sizes=sizes, n_params=n_params,
                      n_ops=len(lines))


def trace_entries(f, param_sizes: dict,
                  name: str = "hess_entries") -> EnergyCode:
    """Trace ``f.hessian_closed_entries`` into one C++ template function

        template <typename T>
        AD_HD void name(const T* x, const T* p, T* h)

    that writes the n x n closed-form Hessian entries to ``h[a*n + b]``.
    One trace serves all n^2 entries, so their common subexpressions are
    computed once.  An entry that is a constant or a parameter is written
    too.

    Raises:
        UnsupportedEnergy: ``f`` has no closed entries, or they use an
            operation that is not emitted or are not an n x n table of
            scalars.
    """
    entries = getattr(f, "hessian_closed_entries", None)
    if entries is None:
        raise UnsupportedEnergy(
            f"{type(f).__name__} has no hessian_closed_entries")
    n = int(f.n_input)
    rows, tr, sizes, n_params = _traced_call(entries, n, param_sizes)
    if len(rows) != n or any(len(r) != n for r in rows):
        raise UnsupportedEnergy(f"the closed entries are not {n} x {n}")
    rets = [_scalar(h, f"entry ({a}, {b})")
            for a, row in enumerate(rows) for b, h in enumerate(row)]
    lines = tr.live_lines(rets)
    stores = [f"  h[{k}] = {r};" for k, r in enumerate(rets)]
    source = (
        "template <typename T>\n"
        f"AD_HD void {name}(const T* x, const T* p, T* h) {{\n"
        "  using S = typename ad::scalar_of<T>::type;\n"
        + "".join(line + "\n" for line in lines + stores)
        + "}\n"
    )
    return EnergyCode(source=source, name=name, n_input=n,
                      param_sizes=sizes, n_params=n_params,
                      n_ops=len(lines))


def cached_trace(cache: weakref.WeakKeyDictionary, trace, f,
                 param_sizes: dict) -> EnergyCode:
    """``trace(f, param_sizes)`` once per energy object and parameter
    sizes: tracing takes milliseconds of host time, as long as a kernel
    launch.  ``cache`` maps energy -> {sizes: code or refusal}; an energy
    that does not trace raises ``UnsupportedEnergy`` again on every call
    without being traced again."""
    key = tuple(sorted(param_sizes.items()))
    per_f = cache.setdefault(f, {})
    if key not in per_f:
        try:
            per_f[key] = trace(f, param_sizes)
        except UnsupportedEnergy as e:
            per_f[key] = e
    code = per_f[key]
    if isinstance(code, UnsupportedEnergy):
        raise UnsupportedEnergy(str(code))
    return code
