"""Every configuration, workload, driver, metric and op is found by its name;
``BENCHMARK.json`` keeps to the benchmark's contract; a new cell is a new
file."""
from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import registry
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.spec()


def test_every_named_file_loads(bench):
    for c in bench["configs"]:
        assert registry.config(c["name"])["name"] == c["name"]
        assert (registry.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"]
        assert hasattr(registry.module("drivers", wl["driver"]), "Driver")
    for m in bench["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)
    for op in registry.names("ops", ".py"):
        mod = registry.module("ops", op)
        assert mod.TARGETS and callable(mod.count) and callable(mod.capture)


def test_names_on_disk_match_the_spec(bench):
    assert set(registry.names("configs", ".json")) == {c["name"] for c in bench["configs"]}
    assert set(registry.names("workloads", ".json")) == {w["name"] for w in bench["workloads"]}
    used = {registry.module("metrics", m["name"]).__name__.removeprefix("benchmark.metrics.")
            for m in bench["per_layer"]}
    assert set(registry.names("metrics", ".py")) == used  # every reader is read


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(registry.config(c["name"]).get("reduced", {}))
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        four += w["chips"] == 4
    assert four <= max(1, len(bench["workloads"]) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        got, layer = registry.cell_metrics(bench, cell)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2 and layer
    assert len(json.dumps(bench)) <= 64 * 1024


def test_an_extra_cell_file_runs_without_an_edit(tmp_path):
    """A later PR adds a cell as one workload file; the harness finds its
    driver, metrics and ops by name and runs it (here on the CPU, small)."""
    here = tiny.make(tmp_path)
    w = json.loads((here / "workloads" / "d435_single.track.json").read_text())
    w["program"] = {"target_pts": 300}
    w["why"] = "sparse tracking, K1 at 300 x 300"
    (here / "workloads" / "d435_single.sparse.json").write_text(json.dumps(w))
    out = tiny.run(here, "d435_single.sparse", seconds=1.0)
    assert out["attempted"] >= 1
    assert set(out["checks"]) == {"det_gap", "pose_gap_mm"}
