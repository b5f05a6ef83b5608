"""``mutation-discipline``: mutable-index state changes through ONE door.

:class:`raft_tpu_torch.neighbors.mutable.MutableIndex` owns the (main, delta,
tombstone) triple under a write lock with a strict protocol: tombstone
bits and host mirrors move together, shape-changing writes re-warm every
recorded serve signature before returning, and compaction swaps the core
atomically after warming.  All of that is
void if outside code pokes the state directly — a raw
``core.words_main[...] |= bit`` skips the device push (reads serve a
stale bitmap), a raw ``m._mut_core = ...`` skips the warm-before-swap
protocol (first read compiles on the request path).

The rule flags writes — ``=``, augmented ``|=``/``+=``, and subscript
stores — whose target attribute is one of the mutable core's state
fields, anywhere in the shipped tree OUTSIDE
``raft_tpu_torch/neighbors/mutable.py``.  Sanctioned exceptions (e.g. the
serialize load replay restoring an archived roster before replaying
writes) carry ``# exempt(mutation-discipline): why``.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.engine import rule

_HOME = "raft_tpu_torch/neighbors/mutable.py"

#: the mutable core's state surface: MutableIndex slots + _Core slots
#: whose writes encode protocol steps (device push, rewarm, swap)
_STATE_ATTRS = frozenset({
    "_mut_core", "_journal",
    "tomb_main_bits", "tomb_delta_bits", "tomb_main_mesh",
    "words_main", "words_delta", "n_words",
    "main_ids", "main_dead", "delta_live", "delta_dead",
    # the port's _Core keeps its rows beside the books
    "main_row", "main_x", "delta_x",
})


def _attr_target(t):
    """The written attribute name for plain (``x.attr``) and subscript
    (``x.attr[...]``) stores, else None."""
    if isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute):
        return t.attr
    return None


@rule("mutation-discipline",
      scope=lambda p: ("raft_tpu_torch/" in p and "/tests/" not in p
                       and not p.endswith(_HOME)),
      doc="mutable-index core state (tombstone bitmaps, delta books, "
          "_mut_core) is written only inside neighbors/mutable.py — raw "
          "writes elsewhere skip the push/rewarm/swap protocol")
def _rule(ctx):
    findings = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Assign, ast.AugAssign)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            attr = _attr_target(t)
            if attr in _STATE_ATTRS \
                    and not ctx.exempt("mutation-discipline", t.lineno):
                findings.append((
                    t.lineno,
                    f"write to mutable-index state `{attr}` outside "
                    "neighbors/mutable.py — route it through "
                    "MutableIndex.upsert/delete/compact (the push/"
                    "rewarm/swap protocol lives there), or mark the "
                    "line exempt(mutation-discipline) with why"))
    return findings
