"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32 and all(map(line, man["command"]))
    for word in man["command"]:
        if "/" in word:   # names only files under paths
            assert any(word.startswith(p + "/") for p in man["paths"])
            assert (ROOT / word).is_file()
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51


def test_budget_fits_24_cells(man):
    runs = 2 + 14 * 24
    total = runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs(man):
    assert 1 <= len(man["configs"]) <= 24
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and c["source"].startswith("https://")
        assert line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]


def test_workloads(man):
    cells = man["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    configs = {c["name"] for c in man["configs"]}
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        h = ROOT / "h100bench"
        assert (h / "traffic" / f"{w['traffic']}.json").is_file()
        assert (h / "limits" / f"{w['name']}.json").is_file()
        runner = json.loads((h / "traffic" / f"{w['traffic']}.json")
                            .read_text())["runner"]
        assert (h / "runners" / f"{runner}.py").is_file()


def cells_of(metric, man):
    return metric.get("workloads", [w["name"] for w in man["workloads"]])


def test_metrics(man):
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["source"] in SOURCES
        assert m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        for c in cells_of(m, man):
            assert c in cells and c in cells_of(e2e[m["moves"]], man)
        assert (ROOT / "h100bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert (ROOT / "h100bench" / "end_to_end"
                / f"{m['name']}.py").is_file()
    for c in cells:   # setup_s, another end-to-end and a per-layer metric
        got = [m["name"] for m in man["end_to_end"] if c in cells_of(m, man)]
        assert "setup_s" in got and len(got) >= 2
        assert any(c in cells_of(m, man) for m in man["per_layer"])


def test_share_metrics_are_named_for_it(man):
    for m in man["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    layers = {m["layer"] for m in man["per_layer"]}
    assert "K2" in layers and "device" in layers


KNOWN = {"label_pipeline": {"logit_gap"},
         "train_epochs": {"loss_gap", "first_loss_gap", "grad_gap",
                          "change_gap", "k1_count_gap"}}
KNOWN["train_legacy"] = KNOWN["train_epochs"]


@pytest.mark.parametrize("cell", json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"],
    ids=lambda w: w["name"])
def test_limits_files_name_numbers(cell):
    """Each cell's limits name numbers its runner gives; a training cell
    compares a loss, the first gradient, the change and K1's counts."""
    h = ROOT / "h100bench"
    lim = json.loads((h / "limits" / f"{cell['name']}.json").read_text())
    runner = json.loads((h / "traffic" / f"{cell['traffic']}.json")
                        .read_text())["runner"]
    assert lim and all(v >= 0 for v in lim.values())
    assert set(lim) <= KNOWN[runner]
    if runner != "label_pipeline":
        assert {"grad_gap", "change_gap", "k1_count_gap"} <= set(lim)
        assert lim["k1_count_gap"] == 0
        assert {"loss_gap", "first_loss_gap"} & set(lim)
