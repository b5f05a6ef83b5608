"""``kernel-discipline``: hand-written kernels live in ONE home with
declared C signatures (the port's ``pallas-discipline``,
``raft_tpu/analysis/rules/pallas_discipline.py``).

1. **Home**: loading a shared library (``ctypes.CDLL``), naming the
   ``nvcc`` compiler and ``@triton.jit`` may only appear under
   ``raft_tpu_torch/kernels/``; ``raft_tpu_torch/native.py`` is the home
   of the host runtime's loader.  A kernel or loader elsewhere ships
   without the layer's contracts: the source hash that names its build,
   the launch counts, the build counts, the engine policy.
2. **Declared symbols**: every ``raft_*`` C symbol a kernel wrapper calls
   must be a key of ``kernels/native.py`` ``_SIGNATURES`` (its argument
   types), so ctypes never guesses an argument's width — an undeclared
   pointer is cut to 32 bits.
"""

from __future__ import annotations

import ast
import functools
import re
from typing import FrozenSet

from raft_tpu_torch.analysis.engine import REPO_ROOT, rule

_HOME = "raft_tpu_torch/kernels/"
_RUNTIME_HOME = "raft_tpu_torch/native.py"
_LOADER = "raft_tpu_torch/kernels/native.py"
_SYMBOL_RE = re.compile(r"raft_[a-z0-9_]+$")
#: declared beside ``_SIGNATURES`` by ``_declare`` for every library
_ALWAYS_DECLARED = frozenset({"raft_cuda_error_string"})


def declared_symbols(tree: ast.Module) -> FrozenSet[str]:
    """The C symbols of a loader module's ``_SIGNATURES`` dict."""
    out = set()
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_SIGNATURES"
                for t in node.targets)):
            continue
        if isinstance(node.value, ast.Dict):
            for lib in node.value.values:
                if isinstance(lib, ast.Dict):
                    out.update(k.value for k in lib.keys
                               if isinstance(k, ast.Constant))
    return frozenset(out) | _ALWAYS_DECLARED


@functools.lru_cache(maxsize=1)
def shipped_symbols() -> FrozenSet[str]:
    """``_SIGNATURES`` of the checkout's kernel loader."""
    src = (REPO_ROOT / _LOADER).read_text()
    return declared_symbols(ast.parse(src))


def _scope(posix: str) -> bool:
    # analysis/ names the tokens in its own rules
    return ("raft_tpu_torch/" in posix
            and "raft_tpu_torch/analysis/" not in posix)


@rule("kernel-discipline", scope=_scope,
      doc="ctypes.CDLL / nvcc / @triton.jit only under kernels/ (native.py "
          "for the host runtime); every raft_* symbol a wrapper calls is "
          "declared in kernels/native.py _SIGNATURES")
def check_kernel_discipline(ctx):
    in_home = _HOME in ctx.posix
    is_runtime = ctx.posix.endswith(_RUNTIME_HOME)
    found = {}

    def add(lineno, msg):
        if not ctx.exempt("kernel-discipline", lineno):
            found.setdefault(lineno, msg)

    for node in ast.walk(ctx.tree):
        if in_home:
            continue
        what = None
        if isinstance(node, ast.Call):
            path = ctx.flow.resolve_call(node)
            f = node.func
            if (path == "ctypes.CDLL" or (isinstance(f, ast.Attribute)
                                          and f.attr == "CDLL")):
                what = None if is_runtime else "ctypes.CDLL"
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and (node.value == "nvcc" or node.value.endswith("/nvcc"))):
            what = "the nvcc compiler"
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if ctx.flow.resolve(target) == "triton.jit" or (
                        isinstance(target, ast.Attribute)
                        and target.attr == "jit"
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "triton"):
                    add(dec.lineno, "@triton.jit outside raft_tpu_torch/"
                        "kernels/ — kernels live in the kernels package "
                        "(build counts, launch counts, engine policy), or "
                        "mark the line exempt(kernel-discipline)")
        if what is not None:
            add(node.lineno,
                f"{what} outside raft_tpu_torch/kernels/ — kernel libraries "
                "are built and loaded by kernels/native.py (the host "
                "runtime by native.py), or mark the line "
                "exempt(kernel-discipline) with why")
    if in_home:
        declared = (declared_symbols(ctx.tree)
                    if ctx.posix.endswith(_LOADER) else shipped_symbols())
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and _SYMBOL_RE.match(node.func.attr)
                    and node.func.attr not in declared):
                add(node.lineno,
                    f"C symbol {node.func.attr} is called but not declared "
                    "in kernels/native.py _SIGNATURES — ctypes would guess "
                    "its argument widths (pointers cut to 32 bits); "
                    "declare its argtypes there")
    return sorted(found.items())
