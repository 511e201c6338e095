"""The layout probes' Pallas bodies (scripts/probe_packgrad.py,
probe_packgrad2.py, probe_seglayout.py, probe_sublanes.py), loaded for the
CPU tests without running the probes.

A probe's module level times its kernels on a TPU and points JAX's
compilation cache into the repository, so it is never imported. `load`
parses the file and keeps only its imports, its constant assignments and
its `def`s, runs them in a fresh namespace, and swaps the namespace's
`pl` for a shim whose `pallas_call` runs the body in interpret mode over a
grid of one step (every probe's output block is the same at every step).
Constants can be overridden (`load("probe_packgrad", B=3)`), which the
bodies read at call time.

`call(body, out_shape, *inputs)` runs a body on numpy inputs and returns
its output as a numpy array.
"""

from __future__ import annotations

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as _pl

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts")


class _Shim:
    """The namespace's `pl`: pallas_call in interpret mode over grid (1,),
    everything else from jax.experimental.pallas."""

    def __getattr__(self, name):
        return getattr(_pl, name)

    @staticmethod
    def pallas_call(kernel, **kw):
        kw["grid"] = (1,)
        kw["interpret"] = True
        return _pl.pallas_call(kernel, **kw)


def _kept(node) -> bool:
    if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
        return True
    if isinstance(node, ast.Assign):
        # constants only: names bound to literals or tuples of literals
        return all(isinstance(t, (ast.Name, ast.Tuple)) for t in node.targets) \
            and _literal(node.value)
    return False


def _literal(node) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Tuple):
        return all(_literal(e) for e in node.elts)
    if isinstance(node, ast.BinOp):
        return _literal(node.left) and _literal(node.right)
    if isinstance(node, ast.Name):
        return True      # NA = NS + NQ
    return False


@functools.lru_cache(maxsize=None)
def _source(name: str) -> ast.Module:
    with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    tree.body = [n for n in tree.body if _kept(n)]
    return tree


def load(name: str, **constants) -> dict:
    """The namespace of scripts/{name}.py's imports, constants and defs,
    with `pl` the interpret-mode shim and `constants` overriding the
    file's."""
    ns: dict = {"__name__": f"probe_{name}"}
    exec(compile(_source(name), os.path.join(SCRIPTS, f"{name}.py"), "exec"),
         ns)
    ns["pl"] = _Shim()
    ns.update(constants)
    return ns


@functools.lru_cache(maxsize=None)
def _compiled(body, out_shape, in_shapes):
    in_specs = [_pl.BlockSpec(s, lambda i: (0, 0)) for s in in_shapes]
    return jax.jit(_Shim.pallas_call(
        body, in_specs=in_specs,
        out_specs=_pl.BlockSpec(out_shape, lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32)))


def call(body, out_shape, *inputs) -> np.ndarray:
    """body's output block over one grid step, inputs whole in VMEM; the
    compiled call is kept per body and shapes."""
    f = _compiled(body, tuple(out_shape), tuple(x.shape for x in inputs))
    return np.asarray(f(*[jnp.asarray(x) for x in inputs]))
