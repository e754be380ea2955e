"""BENCHMARK.json against the rules it is held to: keys, names, units
and lengths, and every file a cell names found by name."""

import json
import re

import pytest

from _bench_util import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"proj|head|expan|d_model|d_ff|per_tok|top_k")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and (ROOT / p).is_dir()
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads_resolve_by_name():
    from bench import harness
    cells = [w["name"] for w in SPEC["workloads"]]
    assert 1 <= len(cells) <= 24 and len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(cells)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(cells) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        r = harness.resolve(SPEC, w["name"], ROOT)
        assert callable(r["kind"].run) and callable(r["kind"].control_readings)
        assert callable(r["init"].weight_specs) and callable(r["init"].make_batch)
        assert set(r["limits"]) and all(
            isinstance(v, float) and v > 0 for v in r["limits"].values())
        assert harness.resolve(SPEC, w["name"], ROOT, smoke=True)["limits"]
        harness.reference_module(r["config"])
        e2e = [m["name"] for m in r["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert r["per_layer"]


def test_metrics():
    from bench import harness
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved) & cells
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert hasattr(harness.load_reader(m["name"], ROOT), "read")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    """setup_s, another end-to-end metric and a per-layer metric."""
    def here(m):
        return cell in m.get("workloads", [cell])
    e2e = [m["name"] for m in SPEC["end_to_end"] if here(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(here(m) for m in SPEC["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel), rel


def test_training_traffic_is_drawn_from_the_configuration_grid():
    """A training mix whose models lie off the configuration's grid is
    refused before any run."""
    from bench import harness
    cell = next(w for w in SPEC["workloads"]
                if harness.resolve(SPEC, w["name"], ROOT)["traffic"]["kind"]
                == "train")
    r = harness.resolve(SPEC, cell["name"], ROOT)
    grid = r["config"]["grid"]
    source = r["config"]["grid_source"]
    assert len(r["traffic"]["models"]) <= grid["models"] <= source["models"]
    assert set(grid["batch"]) <= set(source["batch"])
    assert set(grid["lr"]) <= set(source["lr"])
    off = {**r["traffic"], "models": [{"batch": grid["batch"][0],
                                       "lr": 5e-5}]}
    with pytest.raises(ValueError, match="not drawn from the grid"):
        harness._check_grid(r["config"], off)


@pytest.mark.parametrize("key,folder", [("init", "init"),
                                        ("kind", "kinds")])
def test_a_family_or_kind_is_found_by_name_alone(key, folder, tmp_path):
    """A configuration's family and a mix's kind are files found by the
    name the data gives: a name with no file is refused, naming it."""
    import shutil

    from bench import harness
    for p in ("BENCHMARK.json",):
        shutil.copy(ROOT / p, tmp_path / p)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = SPEC["workloads"][0]
    r = harness.resolve(SPEC, cell["name"], tmp_path)
    if key == "init":
        path = tmp_path / [c for c in SPEC["configs"]
                           if c["name"] == cell["config"]][0]["file"]
    else:
        path = tmp_path / "bench" / "traffic" / f"{cell['traffic']}.json"
    body = json.loads(path.read_text())
    body[key] = "no_such_" + key
    path.write_text(json.dumps(body))
    with pytest.raises(ModuleNotFoundError, match=f"no_such_{key}"):
        harness.resolve(SPEC, cell["name"], tmp_path)
    name = r[key].__name__.rsplit(".", 1)[1]
    assert (ROOT / "bench" / folder / f"{name}.py").is_file()
