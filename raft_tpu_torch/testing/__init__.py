"""Test machinery that ships WITH the library (port of
``raft_tpu/testing``): the deterministic fault-injection plane
(:mod:`raft_tpu_torch.testing.faults`).

It lives inside the package (not under ``tests/``) because the serving
engine's supervisor and refresh path carry the injection hooks, and
operators may enable it in a staging process via ``RAFT_TPU_FAULT_PLAN``.
"""

from raft_tpu_torch.testing.faults import (  # noqa: F401
    FaultPlan,
    InjectedFault,
    InjectedLogicFault,
    active_plan,
    check,
    clear_plan,
    install_plan,
    plan,
)

__all__ = ["FaultPlan", "InjectedFault", "InjectedLogicFault",
           "active_plan", "check", "clear_plan", "install_plan", "plan"]
