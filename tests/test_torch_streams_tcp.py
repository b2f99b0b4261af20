"""The port's TCP stream hub against the JAX package's: the cases of JAX's
``tests/test_streams_tcp.py`` on the port (ordered append, tail-follow,
late-joiner replay, a blocked reader woken by an append, a producer in
another process, ``maxlen`` trimming with readers resuming), and across the
packages: JAX's clients on the port's hub and the port's clients on JAX's
hub. The hub's ``.scf`` mirror reads back through either package's frame
reader, and its counters count what was appended."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from pipelinerl_tpu import streams as j_streams
from pipelinerl_tpu import streams_binary as j_bin
from pipelinerl_tpu.streams_tcp import StreamHub as JStreamHub
from pipelinerl_tpu_torch import streams as t_streams
from pipelinerl_tpu_torch import streams_binary as t_bin
from pipelinerl_tpu_torch.streams_tcp import StreamHub, wait_for_hub

ROOT = Path(__file__).resolve().parents[1]
HUBS = {"port": StreamHub, "jax": JStreamHub}
CLIENTS = {"port": t_streams, "jax": j_streams}


@pytest.fixture(params=["port", "jax"])
def hub(request):
    h = HUBS[request.param](host="127.0.0.1", port=0)
    h.start()
    yield h
    h.stop()


@pytest.fixture(params=["port", "jax"])
def client(request):
    """The package whose streams talk to the hub: its backend set to
    ``tcp`` for the test, then back to ``files``."""
    mod = CLIENTS[request.param]
    yield mod
    mod.set_streams_backend("files")


def _spec(mod, topic="t"):
    return mod.SingleStreamSpec(exp_path="/exp", topic=topic)


def test_append_read_roundtrip(hub, client):
    client.set_streams_backend("tcp", hub=f"127.0.0.1:{hub.port}")
    with client.StreamWriter(_spec(client)) as w:
        for i in range(20):
            w.write({"i": i, "arr": np.arange(4, dtype=np.int32) + i})
    msgs = list(client.StreamReader(_spec(client)).read_available())
    assert [m["i"] for m in msgs] == list(range(20))
    np.testing.assert_array_equal(msgs[3]["arr"], np.arange(4, dtype=np.int32) + 3)


def test_late_joiner_replays_history(hub, client):
    client.set_streams_backend("tcp", hub=f"127.0.0.1:{hub.port}")
    with client.StreamWriter(_spec(client, "late")) as w:
        w.write({"i": 0})
        w.write({"i": 1})
    r1 = client.StreamReader(_spec(client, "late"))
    assert [m["i"] for m in r1.read_available()] == [0, 1]
    with client.StreamWriter(_spec(client, "late")) as w:
        w.write({"i": 2})
    assert [m["i"] for m in r1.read_available()] == [2]
    assert [m["i"] for m in client.StreamReader(_spec(client, "late")).read_available()] == [0, 1, 2]


def test_blocking_read_wakes_on_append(hub, client):
    client.set_streams_backend("tcp", hub=f"127.0.0.1:{hub.port}")
    reader = client.StreamReader(_spec(client, "blk"), poll_interval=0.5)
    got = []

    def consume():
        for msg in reader.read():
            got.append(msg["i"])
            if len(got) >= 3:
                reader.stop()
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.1)
    with client.StreamWriter(_spec(client, "blk")) as w:
        for i in range(3):
            w.write({"i": i})
    t.join(timeout=10)
    assert not t.is_alive() and got == [0, 1, 2]


@pytest.mark.parametrize("producer_pkg", ["pipelinerl_tpu", "pipelinerl_tpu_torch"])
def test_cross_process_producer(tmp_path, producer_pkg):
    """Another OS process, of either package, writes through the port's
    hub; this process tails with both packages' readers."""
    h = StreamHub(host="127.0.0.1", port=0)
    h.start()
    addr = f"127.0.0.1:{h.port}"
    try:
        producer = tmp_path / "producer.py"
        producer.write_text(
            f"from {producer_pkg}.streams import SingleStreamSpec, StreamWriter, set_streams_backend\n"
            f"set_streams_backend('tcp', hub='{addr}')\n"
            "with StreamWriter(SingleStreamSpec(exp_path='/exp', topic='xproc')) as w:\n"
            "    for i in range(50):\n"
            "        w.write({'i': i})\n"
        )
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        proc = subprocess.run([sys.executable, str(producer)], env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        for mod in (t_streams, j_streams):
            mod.set_streams_backend("tcp", hub=addr)
            try:
                assert [m["i"] for m in mod.StreamReader(_spec(mod, "xproc")).read_available()] == list(range(50))
            finally:
                mod.set_streams_backend("files")
    finally:
        h.stop()


def test_hub_maxlen_trims_and_readers_resume(client):
    h = StreamHub(host="127.0.0.1", port=0, maxlen=10)
    h.start()
    try:
        client.set_streams_backend("tcp", hub=f"127.0.0.1:{h.port}")
        reader = client.StreamReader(_spec(client, "trim"))
        with client.StreamWriter(_spec(client, "trim")) as w:
            for i in range(25):
                w.write({"i": i})
        # a late reader (offset 0 < base 15) gets exactly the window kept
        assert [m["i"] for m in reader.read_available()] == list(range(15, 25))
        log = h._logs["trim/0/0"]
        assert len(log.payloads) == 10 and log.base == 15
        with client.StreamWriter(_spec(client, "trim")) as w:
            for i in range(25, 31):
                w.write({"i": i})
        assert [m["i"] for m in reader.read_available()] == list(range(25, 31))
        assert h.counters()["trim/0/0"]["messages"] == 31 and h.counters()["trim/0/0"]["held"] == 10
    finally:
        h.stop()


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_persisted_logs_read_back_in_both_packages(tmp_path, hub_pkg):
    """Each hub mirrors its logs to ``<persist_dir>/<key>.scf``; both
    packages' frame readers read every message back, and the port hub's
    counters hold the messages and payload bytes appended."""
    h = HUBS[hub_pkg](host="127.0.0.1", port=0, persist_dir=str(tmp_path / "hub"))
    h.start()
    addr = f"127.0.0.1:{h.port}"
    sent = [{"i": i, "ids": np.arange(i, dtype=np.int64)} for i in range(12)]
    try:
        wait_for_hub(addr, timeout=10)
        t_streams.set_streams_backend("tcp", hub=addr)
        with t_streams.StreamWriter(t_streams.SingleStreamSpec("/exp", "actor", 0, 1)) as w:
            for m in sent:
                w.write(m)
        counters = h.counters() if hub_pkg == "port" else None
    finally:
        t_streams.set_streams_backend("files")
        h.stop()
    path = tmp_path / "hub" / "actor" / "0" / "1.scf"
    for reader in (t_bin.FrameReader(path), j_bin.FrameReader(path)):
        got = list(reader.read_available())
        assert [m["i"] for m in got] == list(range(12))
        np.testing.assert_array_equal(got[5]["ids"], np.arange(5))
    if counters is not None:
        assert counters["actor/0/1"] == {"messages": 12, "bytes": sum(len(t_bin.encode(m)) for m in sent), "held": 12}


def test_wait_for_hub_times_out_without_a_hub():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(TimeoutError):
        wait_for_hub(f"127.0.0.1:{port}", timeout=0.5)
