"""``collective-discipline``: raw ``torch.distributed`` collectives and
broadcasts anywhere in ``raft_tpu_torch/`` outside ``comms/`` (port of
``raft_tpu/analysis/rules/collectives.py``).  Every collective must launch
through the :class:`~raft_tpu_torch.comms.Comms` wrappers, because
anything else escapes ``Comms.collective_calls``, the count and byte
accounting the MNMG tests and the program audit hold their budgets
against (one allreduce an EM step, one allgather a search batch).
``barrier``, ``get_rank`` and the group constructors move no payload and
are not flagged.

The callee of every call is resolved through the file's value-flow, so
``ar = dist.all_reduce; ar(t)``, ``from torch.distributed import
broadcast as b`` and helper-returned collectives fire at the call line;
the attribute matcher stays as a second net for references that are not
called."""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

#: payload-moving collectives of torch.distributed
BANNED_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "scatter", "scatter_object_list", "gather",
    "gather_object", "send", "recv", "isend", "irecv", "batch_isend_irecv",
})

_BANNED_PATHS = frozenset(f"torch.distributed.{c}"
                          for c in BANNED_COLLECTIVES)


def _scope(posix: str) -> bool:
    return ("raft_tpu_torch/" in posix
            and "raft_tpu_torch/comms/" not in posix)


@rule("collective-discipline", scope=_scope,
      doc="raw torch.distributed collectives outside comms/ (incl. "
          "laundered aliases) escape the collective_calls accounting")
def check_collectives(ctx):
    found = {}  # (lineno, name) -> message

    def add(lineno, name, how):
        if ctx.exempt("collective-discipline", lineno):
            return
        found.setdefault((lineno, name), (
            f"raw collective {name}{how} outside comms/ — it escapes the "
            "Comms.collective_calls count/byte accounting (the launch and "
            "payload budgets go blind); route it through the Comms "
            "wrappers, or mark the line exempt(collective-discipline)"))

    dist_aliases = set()     # names that mean torch.distributed here
    direct_imports = set()   # collective names imported bare
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "torch.distributed":
                for a in node.names:
                    if a.name in BANNED_COLLECTIVES:
                        direct_imports.add(a.asname or a.name)
                        add(node.lineno, a.name,
                            " (`from torch.distributed import`)")
            elif node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        dist_aliases.add(a.asname or "distributed")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    dist_aliases.add(a.asname)
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) \
                and node.attr in BANNED_COLLECTIVES:
            base = node.value
            if ((isinstance(base, ast.Attribute)
                 and base.attr == "distributed")
                    or (isinstance(base, ast.Name)
                        and base.id in dist_aliases)):
                add(node.lineno, f"torch.distributed.{node.attr}", "")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in direct_imports:
                add(node.lineno, f.id, "")
                continue
            path = ctx.flow.resolve_call(node)
            if path in _BANNED_PATHS:
                spelled = (f.id if isinstance(f, ast.Name)
                           else getattr(f, "attr", "?"))
                how = ("" if spelled == path.rsplit(".", 1)[-1]
                       else f" (laundered as `{spelled}`)")
                add(node.lineno, path, how)
    return [(lineno, msg) for (lineno, _), msg in sorted(found.items())]
