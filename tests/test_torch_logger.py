"""The port's logger (``raft_tpu_torch.core.logger``) against the JAX
package's (``raft_tpu.core.logger``): the same level values, the same
spdlog pattern translation, the same records through a callback sink at
every level and threshold, the singleton, and ``time_range`` /
``traced`` recording the same span events (and a TRACE line with
``log=True``)."""

import pytest

import raft_tpu.core.logger as jl
import raft_tpu.telemetry as jtel
import raft_tpu_torch.core.logger as tl
from raft_tpu_torch import telemetry as ttel

LEVELS = ("OFF", "CRITICAL", "ERROR", "WARN", "INFO", "DEBUG", "TRACE")
EMITTERS = ("log_critical", "log_error", "log_warn", "log_info", "log_debug",
            "log_trace")


@pytest.fixture
def loggers():
    """Both singletons, restored to their level, pattern and sinks."""
    saved = [(m, m.Logger.get().get_level(), m.Logger.get().get_pattern())
             for m in (tl, jl)]
    yield tl, jl
    for m, level, pattern in saved:
        log = m.Logger.get()
        log.set_callback(None)
        log.set_level(level)
        log.set_pattern(pattern)


def test_level_values():
    for name in LEVELS:
        assert getattr(tl, name) == getattr(jl, name)
    assert tl._LEVEL_TO_PY == jl._LEVEL_TO_PY


@pytest.mark.parametrize("pattern", ["%v", "[%L] [%H:%M:%S.%f] %v",
                                     "%n %l %t %P: %v", "[%H:%M:%S] %v"])
def test_pattern_translation(pattern):
    assert tl._spdlog_pattern_to_fmt(pattern) == jl._spdlog_pattern_to_fmt(
        pattern)


@pytest.mark.parametrize("level", LEVELS)
def test_callback_records_at_each_threshold(loggers, level):
    got = {}
    for m in loggers:
        records = got.setdefault(m, [])
        log = m.Logger.get()
        log.set_pattern("%l|%v")
        log.set_callback(lambda lvl, msg, r=records: r.append((lvl, msg)))
        log.set_level(getattr(m, level))
        for i, fn in enumerate(EMITTERS):
            getattr(m, fn)("message %d of %s", i, fn)
        log.flush()
    assert got[tl] == got[jl]
    assert ([tl.Logger.get().should_log_for(getattr(tl, n)) for n in LEVELS]
            == [jl.Logger.get().should_log_for(getattr(jl, n))
                for n in LEVELS])
    # OFF lets nothing through; every other threshold lets its own level
    # and the ones above it through
    assert len(got[tl]) == max(0, LEVELS.index(level))


def test_singleton_and_invalid_level(loggers):
    for m in loggers:
        assert m.Logger() is m.Logger.get()
        with pytest.raises(ValueError):
            m.Logger.get().set_level(99)
    assert tl.Logger.get().get_level() == jl.Logger.get().get_level()


def test_time_range_and_traced_record_spans(loggers):
    events = {}
    for m, tel in ((tl, ttel), (jl, jtel)):
        records = []
        log = m.Logger.get()
        log.set_pattern("%v")
        log.set_callback(lambda lvl, msg, r=records: r.append((lvl, msg)))
        log.set_level(m.TRACE)

        @m.traced("logger_test.entry")
        def entry(x):
            return x + 1

        with tel.collect_spans() as spans:
            assert entry(1) == 2
            with m.time_range("logger_test.range", log=True):
                pass
        events[m] = [e["span"] for e in spans.events]
        assert len(records) == 1
        assert records[0][0] == m._LEVEL_TO_PY[m.TRACE]
        assert records[0][1].startswith("logger_test.range: ")
        assert records[0][1].endswith(" ms")
    assert events[tl] == events[jl] == ["logger_test.entry",
                                        "logger_test.range"]
