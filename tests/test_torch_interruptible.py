"""The port's cooperative cancellation (``raft_tpu_torch.core.
interruptible``) and the handle helpers (``default_handle``,
``auto_sync_handle``, ``DeviceResources``), on the CPU.

A waiting ``synchronize`` polls events that are not ready; a cancel from
another thread must end it with ``InterruptedError_`` within the poll
interval (every wait here is bounded).  The token registry is per thread,
as the JAX package's is (``tests/test_handle_threading.py``)."""

import threading
import time

import pytest
import torch

from raft_tpu.core import interruptible as jint
from raft_tpu_torch.core import handle as th
from raft_tpu_torch.core import interruptible as tint
from raft_tpu_torch.core.error import InterruptedError_, RaftError


class _Never:
    """An event that never completes; counts its polls."""

    def __init__(self):
        self.polls = 0

    def query(self):
        self.polls += 1
        return False


class _After:
    """An event that completes at its n-th poll."""

    def __init__(self, n):
        self.n = n

    def query(self):
        self.n -= 1
        return self.n <= 0


def test_token_surface_matches_the_jax_package():
    for name in ("Token", "get_token", "cancel", "yield_", "yield_no_throw",
                 "synchronize", "interruptible"):
        assert hasattr(tint, name) and hasattr(jint, name), name
    assert issubclass(InterruptedError_, RaftError)
    tok = tint.Token()
    assert not tok.cancelled() and not tok.yield_no_throw()
    tok.cancel()
    assert tok.cancelled()
    with pytest.raises(InterruptedError_):
        tok.yield_()
    tok.yield_()                       # the flag was cleared
    tok.cancel()
    assert tok.yield_no_throw() and not tok.yield_no_throw()


@pytest.mark.parametrize("poll_interval", [1e-5, 1e-3])
def test_cancel_ends_a_waiting_synchronize(poll_interval):
    main = threading.get_ident()
    tint.get_token(main)               # made before the canceller runs
    ev = _Never()
    cancelled_at = {}

    def canceller():
        time.sleep(0.05)
        cancelled_at["t"] = time.perf_counter()
        tint.cancel(main)

    t = threading.Thread(target=canceller)
    t.start()
    try:
        t0 = time.perf_counter()
        with pytest.raises(InterruptedError_):
            tint.synchronize(ev, poll_interval=poll_interval,
                             max_interval=1e-3)
        ended = time.perf_counter()
    finally:
        t.join(timeout=5)
    assert not t.is_alive()
    assert ev.polls > 1                # it waited, polling
    # within one poll interval (1 ms at most) of the cancel, plus
    # scheduling slack
    assert ended - cancelled_at["t"] < 0.5
    assert ended - t0 < 5
    tint.yield_()                      # the token is clean again


def test_synchronize_returns_when_ready():
    ev = _After(4)
    tint.synchronize([ev, {"x": torch.ones(3)}], (torch.zeros(2),),
                     poll_interval=1e-5)
    assert ev.n <= 0
    tint.synchronize()                 # nothing to wait on
    tint.synchronize(torch.arange(5), 3, "not an array")


def test_registry_is_per_thread():
    tokens = {}
    gate = threading.Barrier(2, timeout=30)

    def worker(i):
        gate.wait()
        tokens[i] = tint.get_token()
        gate.wait()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert tokens[0] is not tokens[1]
    assert tint.get_token() not in (tokens[0], tokens[1])
    assert tint.get_token() is tint.get_token(threading.get_ident())


def test_context_manager_cancels_the_other_threads_on_interrupt():
    other = {}
    ready = threading.Event()
    done = threading.Event()

    def waiter():
        other["tok"] = tint.get_token()
        ready.set()
        try:
            tint.synchronize(_Never(), max_interval=1e-3)
        except InterruptedError_:
            other["raised"] = True
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(5)
    with pytest.raises(KeyboardInterrupt):
        with tint.interruptible():
            raise KeyboardInterrupt
    assert done.wait(5)
    t.join(timeout=5)
    assert other.get("raised") is True
    with tint.interruptible():
        pass
    tint.yield_()                      # this thread's token is clean


def test_handle_helpers(monkeypatch):
    assert th.DeviceResources is th.Handle
    made = []
    real = th.Handle

    class FakeHandle:
        def __init__(self):
            self.syncs = 0
            made.append(self)

        def sync(self):
            self.syncs += 1

    class SpyHandle(real):
        def __init__(self):
            super().__init__(device="cpu")
            self.syncs = 0

        def sync(self):
            self.syncs += 1

    monkeypatch.setattr(th, "_default_handle", None)
    monkeypatch.setattr(th, "Handle", FakeHandle)
    assert th.default_handle() is th.default_handle()
    assert len(made) == 1

    @th.auto_sync_handle
    def f(x, handle=None):
        return x, handle

    # no handle: the body runs on the current stream and the call waits
    # for that work itself — no default handle is injected or synced
    x, h = f(3)
    assert x == 3 and h is None and made[0].syncs == 0
    mine = SpyHandle()
    x, h = f(4, handle=mine)
    assert h is mine and mine.syncs == 0      # the caller syncs its own
    x, h = f(5, mine)
    assert h is mine and mine.syncs == 0
    assert f.__wrapped__(6) == (6, None)      # the body, unwrapped

    def g(x):
        return x * 2

    assert th.auto_sync_handle(g) is g        # no handle: unchanged


def test_default_handle_needs_a_card(monkeypatch):
    monkeypatch.setattr(th, "_default_handle", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.default_handle()
