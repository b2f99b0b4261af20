"""The port's in-process stream backends beside JAX's ``streams.py``: the
cases of JAX's ``tests/test_streams.py`` run on the ``files``, ``memory``
and ``binary`` backends of both packages with the same messages, and give
the same results; and a ``memory`` reader blocked on an empty stream wakes
at ``stop()`` well before its poll interval, in both."""

import threading
import time

import pytest

from pipelinerl_tpu import streams as j_streams
from pipelinerl_tpu_torch import streams as t_streams

PACKAGES = {"jax": j_streams, "port": t_streams}
BACKENDS = ["files", "memory", "binary"]


def both(case, tmp_path, backend) -> list:
    """``case(mod, exp, backend)`` in each package on its own directory;
    asserts both give the same result and returns it."""
    results = {name: case(mod, str(tmp_path / name), backend) for name, mod in PACKAGES.items()}
    assert results["port"] == results["jax"]
    return results["port"]


def round_trip(mod, exp, backend):
    spec = mod.SingleStreamSpec(exp, "actor")
    with mod.StreamWriter(spec, backend) as w:
        for i in range(5):
            w.write({"i": i, "text": f"m{i}", "xs": [i, 0.5]})
    reader = mod.StreamReader(spec, backend)
    first, again = list(reader.read_available()), list(reader.read_available())
    with mod.StreamWriter(spec, backend) as w:
        w.write({"i": 5})
    return [first, again, list(reader.read_available())]


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip_and_resume(tmp_path, backend):
    first, again, resumed = both(round_trip, tmp_path, backend)
    assert [m["i"] for m in first] == list(range(5)) and again == [] and resumed == [{"i": 5}]


def tail_follow(mod, exp, backend):
    """A reader thread in ``read()`` while a writer appends with pauses; it
    stops itself at the third message."""
    spec = mod.SingleStreamSpec(exp, "t")
    reader = mod.StreamReader(spec, backend, poll_interval=0.01)
    got = []

    def consume():
        for msg in reader.read():
            got.append(msg["i"])
            if msg["i"] == 2:
                reader.stop()
                break

    t = threading.Thread(target=consume)
    t.start()
    with mod.StreamWriter(spec, backend) as w:
        for i in range(4):
            w.write({"i": i})
            time.sleep(0.02)
    t.join(timeout=5)
    return [got, t.is_alive()]


@pytest.mark.parametrize("backend", BACKENDS)
def test_tail_follow_with_a_concurrent_writer(tmp_path, backend):
    assert both(tail_follow, tmp_path, backend) == [[0, 1, 2], False]


def partitions(mod, exp, backend):
    spec = mod.StreamRangeSpec(exp, "training_data", partitions=(0, 1, 2))
    with mod.RangeStreamWriter(spec, backend) as w:
        for i in range(6):
            w.write({"i": i})
        w.write({"i": 100}, partition=1)
    return [[m["i"] for m in mod.StreamReader(spec.single(p), backend).read_available()] for p in range(3)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_robin_and_explicit_partitions(tmp_path, backend):
    assert both(partitions, tmp_path, backend) == [[0, 3], [1, 4, 100], [2, 5]]


def one_at_a_time(mod, exp, backend):
    spec = mod.SingleStreamSpec(exp, "t2")
    with mod.StreamWriter(spec, backend) as w:
        for i in range(10):
            w.write({"i": i})
    reader = mod.StreamReader(spec, backend)
    return [[m["i"] for m in reader.read_available(max_messages=1)] for _ in range(11)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_read_available_max_messages_no_loss(tmp_path, backend):
    """Stopping mid-chunk keeps the rest of what was drained."""
    assert both(one_at_a_time, tmp_path, backend) == [[i] for i in range(10)] + [[]]


def stop_wakes(mod, exp, backend):
    """A reader blocked in ``read()`` on an empty memory stream with a 30 s
    poll interval; ``stop()`` from another thread ends it at once."""
    reader = mod.StreamReader(mod.SingleStreamSpec(exp, "idle"), backend, poll_interval=30.0)
    got = []
    t = threading.Thread(target=lambda: got.extend(reader.read()))
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    reader.stop()
    t.join(timeout=5)
    return [got, t.is_alive(), time.monotonic() - t0 < 2.0]


def test_stop_wakes_a_blocked_memory_reader(tmp_path):
    assert both(stop_wakes, tmp_path, "memory") == [[], False, True]
