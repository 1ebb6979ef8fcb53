"""The benchmark's definition: every cell, configuration, traffic mix and
metric is found by name, ``BENCHMARK.json`` keeps the format's rules
(names, units, bounds, keys), and a new cell is files and an entry,
with no file edited."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from bench import spec
from bench.model import dims

ROOT = spec.ROOT
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"]
    assert BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BM[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in BM["configs"] + BM["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in BM["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert set(e2e) == {"ttft_p95_ms", "itl_p95_ms", "train_tok_s",
                        "joules_per_token", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert (ROOT / "bench" / "drivers"
            / f"{c.traffic['driver']}.py").exists()
    d = dims(c.config)
    assert d.n_layers >= 1 and d.d_model > 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BM["workloads"]}
    assert used == {c["name"] for c in BM["configs"]}
    files = [c["file"] for c in BM["configs"]]
    assert len(files) == len(set(files))
    for c in BM["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/")
        assert set(c["reduced"]) == set(body["reduced"])
        assert body["source"] == c["source"]


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path / "bench")
    traffic = json.loads((tmp_path / "bench" / "traffic"
                          / "chat.json").read_text())
    traffic["arrivals"]["rate"] = 1.5
    (tmp_path / "bench" / "traffic" / "chat_slow.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench" / "metrics" / "engine.queue_ms.py").write_text(
        "def read(rec):\n    return 1.0\n")
    bm["workloads"].append({"name": "mixtral-8x22b.chat_slow",
                            "config": "mixtral-8x22b",
                            "traffic": "chat_slow", "chips": 1,
                            "why": "a slower chat mix"})
    bm["per_layer"].append({"name": "engine.queue_ms", "unit": "ms",
                            "better": "lower", "source": "program_span",
                            "layer": "engine", "moves": "ttft_p95_ms",
                            "workloads": ["mixtral-8x22b.chat_slow"]})
    for m in bm["end_to_end"]:
        if "workloads" in m and "mixtral-8x22b.chat" in m["workloads"]:
            m["workloads"].append("mixtral-8x22b.chat_slow")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    cell = spec.load_cell("mixtral-8x22b.chat_slow", root=tmp_path)
    assert cell.traffic["arrivals"]["rate"] == 1.5
    assert [m["name"] for m in cell.per_layer] == ["engine.queue_ms"]
    assert spec.reader("engine.queue_ms", root=tmp_path).read({}) == 1.0
    after = _digest(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("no-such-cell")
