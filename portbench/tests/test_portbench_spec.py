"""BENCHMARK.json against the benchmark's contract, every name in it
resolving to its files, and a configuration, a traffic mix and a metric
added as files of their own found without an edit."""

import json
import re
import shutil

import pytest

from portbench.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units_keep_to_the_contract():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                assert text is None or (0 < len(text) <= 200 and "\n" not in text
                                        and "\t" not in text)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        cell = spec.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported and m["moves"] in e2e
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_resolves_to_its_files():
    for kind, paths in spec.all_files(BENCH).items():
        assert paths, kind
        for path in paths:
            assert path.is_file(), path
            assert spec.PACKAGE in path.parents
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert callable(cell.runner().run) and callable(cell.family().specs)
        for name, entry in cell.limits.items():
            assert entry.get("compared", True) is False or entry["limit"] > 0, name


def test_configs_name_their_source_and_cut_nothing():
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert c["source"].startswith("https://") and c["source"].split(" ")[0] in cfg["source"]


def test_a_config_a_mix_and_a_metric_added_as_files_are_found_without_edits(tmp_path):
    package = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.PACKAGE / sub, package / sub)
    config = spec.load_json(spec.PACKAGE / "configs" / "ddim_super_small_128.json")
    config.update(name="ddim_super_small_64", resolution=64)
    (package / "configs" / "ddim_super_small_64.json").write_text(json.dumps(config))
    mix = dict(spec.load_json(spec.PACKAGE / "traffic" / "ddib_b128.json"), batch=512)
    (package / "traffic" / "ddib_b512.json").write_text(json.dumps(mix))
    (package / "limits" / "ddim64.ddib.json").write_text(json.dumps({"step_gap": {"limit": 1}}))
    (package / "metrics" / "batches.transfer.py").write_text(
        "def read(r):\n    return r['window_s'] and 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "ddim_super_small_64", "source": "https://example.org",
                             "file": "portbench/configs/ddim_super_small_64.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ddim64.ddib", "config": "ddim_super_small_64",
                               "traffic": "ddib_b512", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ddim128.ddib" in m.get("workloads", []):
            m["workloads"].append("ddim64.ddib")
    bench["per_layer"].append({"name": "batches.transfer", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "transfer loop",
                               "moves": "transfers_per_s"})
    cell = spec.load_cell("ddim64.ddib", bench, root=tmp_path, package=package)
    assert cell.config["resolution"] == 64 and cell.traffic["batch"] == 512
    assert cell.runner().__name__ == "portbench.runners.ddib"
    assert "batches.transfer" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("batches.transfer", package).read({"window_s": 2.0}) == 1.0
    for paths in spec.all_files(bench, root=tmp_path, package=package).values():
        assert all(p.is_file() for p in paths)
    # a metric listing its cells is reported there only
    old = spec.load_cell("ddim128.train", bench, root=tmp_path, package=package)
    assert "batches.transfer" not in [m["name"] for m in old.per_layer]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")


def test_the_fine_tunes_host_paced_rate_is_read_per_layer():
    cell = spec.load_cell("sd21_128.finetune")
    assert "samples_per_s.finetune" in [m["name"] for m in cell.per_layer]
    assert [m["name"] for m in cell.end_to_end] == ["train_peak_mem_gib", "setup_s"]
    read = spec.metric_reader("samples_per_s.finetune").read
    assert read({"samples": 640, "window_s": 2.0}) == 320.0
    assert read({"window_s": 2.0}) is None
