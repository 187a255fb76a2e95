"""BENCHMARK.json against the benchmark's contract: every cell resolves to
its configuration, mix, generator and metric files under mumbench/, and
every name, unit, text field, bound and count keeps to the contract's
limits. Nothing here needs a card."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for word in cmd[1:]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    metric_names = [m["name"] for m in METRICS]
    assert len(metric_names) == len(set(metric_names))


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_entry_and_reader(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    e2e = m in BENCH["end_to_end"]
    allowed = KEYS["end_to_end" if e2e else "per_layer"] | {"workloads"}
    assert KEYS["end_to_end" if e2e else "per_layer"] <= set(m) <= allowed
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
        assert cell in CELLS
    assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                       metric + ".py"))


def test_setup_metric_is_there_with_its_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
    assert _text(w["why"])
    for key in ("config", "traffic"):
        assert NAME.match(w[key])
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    assert os.path.isfile(os.path.join(BENCH_DIR, "generators",
                                       config["generator"] + ".py"))
    with open(os.path.join(BENCH_DIR, "mixes", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    assert mix["backend"] in ("pfp", "direct")
    assert set(mix["options"]) == {"num_distinct_docs", "rare_freq",
                                   "max_mem_freq"}
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    def reports(m):
        return cell in m.get("workloads", [cell])
    e2e = {m["name"] for m in BENCH["end_to_end"] if reports(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in BENCH["per_layer"])


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    cfg = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(cfg) == KEYS["config"]
    assert _text(cfg["source"]) and _text(cfg["why"])
    assert any(cfg["file"].startswith(p + "/") for p in BENCH["paths"])
    assert len(cfg["reduced"]) <= 16
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    assert config["name"] == name
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in config
        assert config[key] != config["published"][key]
    # no two configurations share a file; every one is used by a cell
    assert sum(c["file"] == cfg["file"] for c in BENCH["configs"]) == 1
    assert any(w["config"] == name for w in BENCH["workloads"])
