"""Run a JAX-package test module's cases against the port's modules.

The fleet's control plane (router, event loop, autoscaler, supervisor,
forensics) is a copy of the JAX package's, so its tests are the JAX
package's tests with every ``dllama_tpu.X`` swapped for
``dllama_tpu_torch.X``. :func:`mirror` makes that swap without copying a
line: it returns a test module's ``test_*`` functions rebound to globals in
which

* every module of the JAX package, and every function or class imported
  from one, is replaced by the port's object of the same dotted name;
* every function or class a test module defines (or imports from another
  test module) whose code reaches such a name is rebound the same way,
  so ``RouterUnderTest`` builds the port's router and ``make_state`` the
  port's ``RouterState``; the rest (a fake replica that speaks plain
  HTTP) are shared as they are;
* ``overrides`` names the module-level values that are instances of a JAX
  class (a ``PolicyConfig`` built at import) and their port replacements.

A mirroring file puts the result in its namespace and defines the
fixtures the cases ask for (an autouse fixture that clears the port's
``faults``, a replica pair on the port's server). Marks (``faults``,
``parametrize``) travel with each function.
"""

from __future__ import annotations

import functools
import importlib
import types

JAX_PKG, PORT_PKG = "dllama_tpu", "dllama_tpu_torch"


def _port_name(name: str):
    if name == JAX_PKG or name.startswith(JAX_PKG + "."):
        return PORT_PKG + name[len(JAX_PKG):]
    return None


def port_of(obj):
    """The port's counterpart of a JAX-package module, function or class,
    or None for anything else."""
    if isinstance(obj, types.ModuleType):
        name = _port_name(obj.__name__)
        return importlib.import_module(name) if name else None
    if isinstance(obj, (type, types.FunctionType)):
        mod = getattr(obj, "__module__", None)
        name = _port_name(mod) if isinstance(mod, str) else None
        if name is None:
            return None
        return functools.reduce(getattr, obj.__qualname__.split("."),
                                importlib.import_module(name))
    return None


def _code_names(code) -> set:
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


def _is_test_object(obj) -> bool:
    mod = getattr(obj, "__module__", None)
    return (isinstance(obj, (type, types.FunctionType))
            and isinstance(mod, str) and mod.startswith("tests."))


class _Rebinder:
    def __init__(self, overrides: dict):
        self.overrides = overrides
        self.needs_memo: dict = {}
        self.objs: dict = {}
        self.globs: dict = {}

    # -- does an object reach the JAX package? -------------------------------

    def needs(self, obj) -> bool:
        key = id(obj)
        if key in self.needs_memo:
            return self.needs_memo[key]
        self.needs_memo[key] = False  # cycle guard
        if isinstance(obj, type):
            hit = any(self.needs(f) for f in vars(obj).values()
                      if isinstance(f, types.FunctionType))
        else:
            g = obj.__globals__
            hit = False
            for n in _code_names(obj.__code__):
                if n in self.overrides and n in g:
                    hit = True
                elif n in g:
                    v = g[n]
                    hit = port_of(v) is not None or (
                        _is_test_object(v) and self.needs(v))
                if hit:
                    break
        self.needs_memo[key] = hit
        return hit

    # -- rebinding ---------------------------------------------------------

    def value(self, v):
        p = port_of(v)
        if p is not None:
            return p
        if _is_test_object(v) and self.needs(v):
            return self.rebind(v)
        return v

    def globals_for(self, g: dict) -> dict:
        key = id(g)
        if key not in self.globs:
            new = self.globs[key] = dict(g)
            for k, v in g.items():
                new[k] = self.value(v)
            for k, v in self.overrides.items():
                if k in new:
                    new[k] = v
        return self.globs[key]

    def function(self, f):
        g = self.globals_for(f.__globals__)
        new = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__, f.__closure__)
        new.__kwdefaults__ = f.__kwdefaults__
        new.__dict__.update(f.__dict__)  # pytest marks
        new.__qualname__, new.__doc__ = f.__qualname__, f.__doc__
        return new

    def rebind(self, obj):
        key = id(obj)
        if key in self.objs:
            return self.objs[key]
        if isinstance(obj, types.FunctionType):
            self.objs[key] = new = self.function(obj)
            return new
        ns = {k: self.function(v) if isinstance(v, types.FunctionType) else v
              for k, v in vars(obj).items() if k not in ("__dict__", "__weakref__")}
        self.objs[key] = new = type(obj.__name__, obj.__bases__, ns)
        return new


def mirror(module, skip=(), overrides=None) -> dict:
    """``{name: function}`` for every ``test_*`` function that ``module``
    defines and whose code reaches the JAX package, except those in
    ``skip``, rebound to the port's modules. A case that reaches no module
    of the package (a stdlib round trip) tests nothing of the port and is
    left out."""
    rb = _Rebinder(dict(overrides or {}))
    return {name: rb.rebind(obj) for name, obj in vars(module).items()
            if name.startswith("test_") and isinstance(obj, types.FunctionType)
            and obj.__module__ == module.__name__ and name not in skip
            and rb.needs(obj)}


def rebound(module, name: str, overrides=None):
    """One helper of ``module`` (a fake, ``RouterUnderTest``) rebound to the
    port's modules, for a mirroring file's own tests."""
    rb = _Rebinder(dict(overrides or {}))
    obj = getattr(module, name)
    return rb.rebind(obj) if rb.needs(obj) else obj
