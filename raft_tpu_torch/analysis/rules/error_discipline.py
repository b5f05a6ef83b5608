"""``error-discipline``: no swallowed errors in the failure-handling
surfaces — ``raft_tpu_torch/serve/``, ``raft_tpu_torch/comms/`` and every hot-path-
registry module.

The failure model (``serve/supervise.py``) is a set of TYPED
contracts: shed requests get a ``RejectedError``, transient dispatch
failures retry, logic bugs fail fast, a broken clique poisons loudly.  A
``bare except:`` (which also eats ``KeyboardInterrupt``/``SystemExit``)
or an ``except Exception: pass`` anywhere on those surfaces silently
converts a contract violation into nothing — the precise failure class
the serving layer exists to rule out.  Two shapes are flagged:

* ``except:`` with no exception type — always (type the catch; a
  deliberate catch-all over third-party teardown carries the marker);
* ``except Exception`` / ``except BaseException`` whose handler body
  SWALLOWS — nothing but ``pass``/``...``/``continue``/bare ``return``/
  ``return None``.  A handler that logs, wraps, re-raises, records a
  result slot, or returns a real value is handling, not swallowing.

Sanctioned uses carry the unified marker
(``# exempt(error-discipline): why``).
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis import hotpaths
from raft_tpu_torch.analysis.engine import rule

_BROAD = ("Exception", "BaseException")


def _scope(posix: str) -> bool:
    return ("raft_tpu_torch/serve/" in posix or "raft_tpu_torch/comms/" in posix
            or hotpaths.match(posix) is not None)


def _broad_names(type_node) -> bool:
    """True when the except clause names Exception/BaseException (directly,
    dotted, or anywhere in a tuple)."""
    for node in ast.walk(type_node):
        if isinstance(node, ast.Name) and node.id in _BROAD:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _BROAD:
            return True
    return False


def _swallows(body) -> bool:
    """A handler body that discards the error without any handling."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / bare `...`
        if isinstance(stmt, ast.Return) and (
                stmt.value is None
                or (isinstance(stmt.value, ast.Constant)
                    and stmt.value.value is None)):
            continue
        return False
    return True


def check_error_discipline(tree, exempt):
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            if not exempt(node.lineno):
                findings.append((
                    node.lineno,
                    "bare `except:` on a failure-handling surface — it "
                    "catches KeyboardInterrupt/SystemExit and erases the "
                    "typed failure contract (serve/supervise.py); "
                    "name the exception classes, or mark the line "
                    "exempt(error-discipline) with why"))
            continue
        if _broad_names(node.type) and _swallows(node.body):
            if not exempt(node.lineno):
                findings.append((
                    node.lineno,
                    "`except Exception` that swallows (body is only "
                    "pass/.../continue/return None) — a silently eaten "
                    "error on a serve/comms/hot-path surface converts a "
                    "contract violation into nothing; handle it (log, "
                    "wrap, record, re-raise) or mark the line "
                    "exempt(error-discipline) with why"))
    return findings


@rule("error-discipline",
      scope=_scope,
      doc="bare except / swallowed `except Exception` in serve/, comms/ "
          "and hot-path-registry modules — typed failure contracts must "
          "not be silently erased")
def _rule(ctx):
    return check_error_discipline(
        ctx.tree, exempt=lambda ln: ctx.exempt("error-discipline", ln))
