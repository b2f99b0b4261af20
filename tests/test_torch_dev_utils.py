"""The port's dev tools against the JAX package's on one experiment
directory: ``browse`` (list, dump, ``-n``, ``--stats``) over streams in the
``files`` and ``binary`` backends prints what JAX's prints, and
``gather_jsons`` writes what JAX's writes; the JAX package's own cases
(``tests/test_dev_utils.py``) on the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from pipelinerl_tpu import browse as j_browse
from pipelinerl_tpu import gather_jsons as j_gather
from pipelinerl_tpu_torch import browse, gather_jsons
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamWriter

ROOT = Path(__file__).resolve().parents[1]


def experiment(path: Path) -> Path:
    """Streams of both backends: actor groups (files), stats (binary), a
    second partition and instance."""
    with StreamWriter(SingleStreamSpec(str(path), "actor"), backend="files") as w:
        for i in range(5):
            w.write({"group_id": f"g{i}", "reward": i / 4, "finished": i % 2 == 0, "samples": [{"n": i}]})
    with StreamWriter(SingleStreamSpec(str(path), "stats"), backend="binary") as w:
        for i in range(3):
            w.write({"step": i, "reward_mean": 0.5 + i, "tag": "x"})
    with StreamWriter(SingleStreamSpec(str(path), "training_data", 1, 2), backend="files") as w:
        w.write({"tokens": [1, 2, 3], "length": 3})
    return path


ARGS = [[], ["actor"], ["actor/0/0", "-n", "2"], ["actor", "--stats"], ["stats/0/0"], ["stats", "--stats"],
        ["stats", "-n", "1"], ["training_data/1/2"], ["training_data/1/2", "--stats"], ["missing"]]


@pytest.mark.parametrize("args", ARGS, ids=lambda a: " ".join(a) or "list")
def test_browse_prints_what_jax_prints(tmp_path, capsys, args):
    exp = experiment(tmp_path / "exp")
    j_browse.main([str(exp), *args])
    want = capsys.readouterr().out
    browse.main([str(exp), *args])
    assert capsys.readouterr().out == want
    assert want or args == ["missing"]


def test_browse_cli_lists_topics(tmp_path):
    exp = experiment(tmp_path / "exp")
    out = subprocess.run([sys.executable, "-m", "pipelinerl_tpu_torch.browse", str(exp)], cwd=ROOT,
                         capture_output=True, text=True, timeout=60, check=True).stdout
    assert out.split() == ["actor/0/0", "stats/0/0", "training_data/1/2"]


def test_browse_lists_and_reads(tmp_path):
    spec = SingleStreamSpec(str(tmp_path), "actor")
    with StreamWriter(spec) as writer:
        writer.write({"reward": 1.0, "group_id": "g0"})
        writer.write({"reward": 0.5, "group_id": "g1"})
    assert browse._find_topics(tmp_path) == ["actor/0/0"]
    msgs = list(browse._iter_messages(tmp_path, "actor/0/0"))
    assert [m["group_id"] for m in msgs] == ["g0", "g1"]
    stats = browse._summarize(msgs)
    assert stats["messages"] == 2
    assert stats["numeric"]["reward"]["mean"] == 0.75


def test_gather_jsons_writes_what_jax_writes(tmp_path):
    for root in (tmp_path / "port", tmp_path / "jax"):
        (root / "a" / "b").mkdir(parents=True)
        (root / "a" / "one.json").write_text(json.dumps({"id": 1, "x": [1, 2]}))
        (root / "a" / "b" / "three.json").write_text(json.dumps({"id": 3}))
        (root / "two.json").write_text(json.dumps({"id": 2, "nested": {"k": "v"}}))
        (root / "skip.txt").write_text("not json")
    for _ in range(2):  # a second run does not ingest its own output
        dst = gather_jsons.gather_jsons(tmp_path / "port")
        jdst = j_gather.gather_jsons(tmp_path / "jax")
        assert dst.relative_to(tmp_path / "port") == jdst.relative_to(tmp_path / "jax")
        assert dst.read_bytes() == jdst.read_bytes()
    assert sorted(g["id"] for g in json.loads(dst.read_text())) == [1, 2, 3]
    subprocess.run([sys.executable, "-m", "pipelinerl_tpu_torch.gather_jsons", str(tmp_path / "port")], cwd=ROOT,
                   timeout=60, check=True)
    assert dst.read_bytes() == jdst.read_bytes()
