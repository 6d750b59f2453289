"""The reader of ``graph_step_share.catalog`` on hand-built span tables: no
step replayed, some replayed, and a window without step spans."""

import types

import numpy as np

from portbench import run, spans

P = spans.PREFIX


def ctx(events):
    """A traced context whose host events are ``(name, start, end)`` in ns."""
    trace = types.SimpleNamespace(cpu_name=[e[0] for e in events],
                                  cpu_start=np.array([e[1] for e in events], dtype=np.int64),
                                  cpu_end=np.array([e[2] for e in events], dtype=np.int64))
    return types.SimpleNamespace(trace=trace)


def steps(n, replayed):
    """``n`` steps of 10 ns, the last ``replayed`` of them holding a replay
    span, and the capture inside the first replayed step."""
    events = [(P + "nested.run", 0, 10 * n)]
    for i in range(n):
        events.append((P + "nested.step", 10 * i, 10 * i + 9))
        if i >= n - replayed:
            events.append((P + "nested.replay", 10 * i + 2, 10 * i + 8))
            if i == n - replayed:
                events.append((P + "nested.capture", 10 * i + 1, 10 * i + 2))
        else:
            events.append((P + "nested.walk_step", 10 * i + 1, 10 * i + 5))
    return events


def test_no_step_replayed_reads_zero():
    assert run.read_metric("graph_step_share.catalog", ctx(steps(4, 0))) == 0.0


def test_the_share_of_steps_replayed():
    assert run.read_metric("graph_step_share.catalog", ctx(steps(1550, 1549))) == 1549 / 1550
    assert run.read_metric("graph_step_share.catalog", ctx(steps(8, 7) + steps(4, 0))) == 7 / 12


def test_a_window_without_steps_reads_nothing():
    assert run.read_metric("graph_step_share.catalog", ctx([])) is None
    assert run.read_metric("graph_step_share.catalog", ctx([(P + "nested.weights", 0, 5), ("aten::add", 1, 2)])) is None
