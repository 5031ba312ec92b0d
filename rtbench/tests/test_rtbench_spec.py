"""BENCHMARK.json against the files it names and the contract's rules."""

import json
import re
import shutil

import pytest
import torch

from rtbench import drives, guard, spec
from rtbench.reference import scene as rscene
from rtbench.reference import trace as rtrace

BENCH = spec.load_benchmark()
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(BENCH, cell)
    assert issubclass(c.drive, drives.Drive)
    assert c.drive.kind == c.traffic["drive"]
    ref = c.config["reference"]
    assert (spec.ROOT / "reference" / "scenes" / f"{ref['scene']}.py").is_file()
    for rule in [ref["spheres"], ref.get("triangles")]:
        assert rule is None or (rtrace.ROOT / "rules" / f"{rule}.py").is_file()
    for rule in ref["albedo"]:
        assert (rtrace.ROOT / "albedo" / f"{rule}.py").is_file()
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)
    assert c.limits["limits"]
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME_RE.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
    for text in [w["why"] for w in BENCH["workloads"]] + [
            c["why"] for c in BENCH["configs"]] + [
            c["source"] for c in BENCH["configs"]] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_files_are_named_from_names():
    for path in spec.ROOT.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_per_layer_entries_match_their_readers():
    for m in BENCH["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (m["layer"], m["unit"], m["source"], m["moves"], m["better"]) \
            == (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER), m


def test_moves_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        if "workloads" not in m:
            assert "workloads" not in moved, m["name"]


def test_every_cell_reports_a_per_layer_metric_and_one_chip():
    for w in BENCH["workloads"]:
        c = spec.resolve(BENCH, w["name"])
        assert w["chips"] == 1
        assert [e for e, _ in c.per_layer]


def test_configs_hold_their_reduced_list():
    for c in BENCH["configs"]:
        with open(spec.ROOT.parent / c["file"]) as f:
            cfg = json.load(f)
        assert c["file"].startswith("rtbench/configs/")
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]


def test_a_new_metric_file_is_picked_up(tmp_path):
    root = tmp_path / "rtbench"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "metrics" / "dummy.count.py").write_text(
        'LAYER = "device"\nUNIT = "count"\nSOURCE = "program_counter"\n'
        'MOVES = "mpaths_per_s"\nBETTER = "higher"\n\n\n'
        'def read(run):\n    return 42.0\n')
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({
        "name": "dummy.count", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "mpaths_per_s", "workloads": ["cover.north_star"]})
    cell = spec.resolve(bench, "cover.north_star", root=root)
    readers = {e["name"]: mod for e, mod in cell.per_layer}
    assert readers["dummy.count"].read(None) == 42.0
    # A traced run of the cell reports it.
    from rtbench import run
    from rtbench.tests.tiny import TINY

    cell.traffic = {**cell.traffic, **TINY["renders"],
                    "camera": TINY["renders"]["camera"]}
    code, result = run.run_cell(cell, 5, 0.2, True, device="cpu",
                                log=lambda m: None)
    assert code == 0 and result["metrics"]["dummy.count"]["value"] == 42.0
    assert "dummy.count" not in {
        e["name"] for e, _ in spec.resolve(bench, "mesh3.rays", root=root
                                           ).per_layer}


def test_a_new_drive_and_traffic_file_are_picked_up(tmp_path):
    root = tmp_path / "rtbench"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "drives" / "every_other.py").write_text(
        'from rtbench import plugins, spec\n\n'
        'Renders = plugins.load(spec.ROOT, "drives", "renders").DRIVE\n\n\n'
        'class EveryOther(Renders):\n    kind = "every_other"\n\n\n'
        'DRIVE = EveryOther\n')
    traffic = json.loads((root / "traffic" / "render.json").read_text())
    traffic.update(drive="every_other", gather="radix")
    (root / "traffic" / "other.json").write_text(json.dumps(traffic))
    (root / "limits" / "mesh3.other.json").write_text(
        (root / "limits" / "mesh3.render.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mesh3.other", "config": "mesh3",
                               "traffic": "other", "chips": 1, "why": "x"})
    cell = spec.resolve(bench, "mesh3.other", root=root)
    d = drives.make(cell, 3, "cpu")
    assert d.kind == "every_other"
    # Keys the drive does not read go to the entry it builds (Renderer).
    assert d.passed() == {"max_rays_per_batch": 1048576, "gather": "radix"}


def test_reference_rules_are_found_by_the_names_in_the_configuration(
        tmp_path, monkeypatch):
    shutil.copytree(rtrace.ROOT, tmp_path / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "reference" / "rules" / "counted.py").write_text(
        'from rtbench import plugins\nfrom rtbench.reference import trace\n'
        '\nFLAT = plugins.load(trace.ROOT, "rules", "sphere_flat")\n'
        'CALLS = []\n\n\ndef winner(t, rays):\n'
        '    CALLS.append(rays[0].shape[0])\n'
        '    return FLAT.winner(t, rays)\n')
    monkeypatch.setattr(rtrace, "ROOT", tmp_path / "reference")
    cfg = spec.resolve(BENCH, "cover.north_star").config
    sph, _ = rscene.scene_of(cfg)
    counted = dict(cfg, reference=dict(cfg["reference"], spheres="counted"))
    t = rtrace.on_device(rscene.sphere_table(sph), None, "cpu", torch.float32,
                         counted)
    cam = rscene.camera_vector(dict(cfg["camera"], image_width=16))
    rtrace.camera_paths(t, torch.from_numpy(cam), 16, 1, torch.arange(8),
                        torch.zeros(8, dtype=torch.int64), 2)
    assert t.sphere_rule.CALLS and t.sphere_rule.CALLS[0] == 8
    with pytest.raises(FileNotFoundError, match="rules"):
        missing = dict(cfg, reference=dict(cfg["reference"],
                                           spheres="no_such_rule"))
        rtrace.on_device(rscene.sphere_table(sph), None, "cpu", torch.float32,
                         missing)


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["raytracing_tpu_torch", "raytracing_tpu_torch.ops.trace",
             "jaxtyping", "flaxen", "raytracing_tpu", "raytracing_tpu.ops",
             "jax", "jax.numpy", "jaxlib", "flax.linen", "torch"]
    assert guard.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "raytracing_tpu",
        "raytracing_tpu.ops"]
