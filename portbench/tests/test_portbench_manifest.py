"""The manifest: files found by name, and BENCHMARK.json kept to its rules."""
import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _tree(tmp_path):
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "newnet.json").write_text(json.dumps({"net": {"name": "vnet"}}))
    (here / "traffic" / "newmix.json").write_text(json.dumps({"kind": "infer", "n": 3}))
    (here / "limits" / "newnet.newmix.json").write_text(json.dumps({"mask_gap": 0.1}))
    (here / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return run.get('x')\n")
    return here, {
        "configs": [{"name": "newnet", "file": "portbench/configs/newnet.json"}],
        "workloads": [{"name": "newnet.newmix", "config": "newnet",
                       "traffic": "newmix", "chips": 1}],
        "end_to_end": [{"name": "setup_s"}],
        "per_layer": [{"name": "new.metric", "workloads": ["newnet.newmix"]},
                      {"name": "other", "workloads": ["elsewhere"]}],
    }


def test_a_new_cell_is_found_by_its_names(tmp_path):
    here, man = _tree(tmp_path)
    cell = manifest.Cell(man, "newnet.newmix", here=str(here))
    assert cell.config == {"net": {"name": "vnet"}}
    assert cell.traffic["n"] == 3 and cell.limits == {"mask_gap": 0.1}
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert cell.reader("new.metric")({"x": 7}) == 7


def test_an_unknown_cell_is_refused(tmp_path):
    here, man = _tree(tmp_path)
    with pytest.raises(KeyError):
        manifest.Cell(man, "nope", here=str(here))


BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_its_files_and_metrics(name):
    cell = manifest.Cell(BENCH, name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "a cell reports at least one per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, not reported in {name}"
        assert callable(cell.reader(m["name"]))
    for key in ("pool",):
        assert key in cell.traffic


def test_the_manifest_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    root = manifest.ROOT
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(root, c["file"]))
        assert c["file"].startswith("portbench/")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024
