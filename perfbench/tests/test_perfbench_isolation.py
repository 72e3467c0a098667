"""What the benchmark may load, and that it is driven by data: no module
of JAX, of the JAX package or of its benchmarks (top-level names compared
whole), a reference that imports nothing of the program, and a cell, a
configuration and a metric added as new files, with no file of the
benchmark edited."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


RUN_TINY = """
import dataclasses, json, sys, time
import torch
from perfbench import bench
from repro_torch import configs
name = sys.argv[1]
cell = bench.load_cell(name)
cell.config = dict(dataclasses.asdict(configs.get_reduced(sys.argv[2])),
                   **json.loads(sys.argv[3]))
cell.workload.update(json.loads(sys.argv[4]))
out = bench.run_cell(cell, 2**33 + 5, 0.2, sys.argv[5] == "1",
                     torch.device("cpu"), time.perf_counter())
import importlib.util
spec = importlib.util.spec_from_file_location("perfbench_run",
                                              "perfbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "metrics": sorted(out["metrics"]),
                  "correct": out["correct"],
                  "layouts": sorted(m for m in sys.modules if m.startswith(
                      "perfbench.reference.layouts."))}))
"""

DECODE_TINY = {"batch": 2, "context": 8, "max_seq": 12}


def _run_tiny(cwd: Path, name: str, arch: str, traced: str,
              cfg: str = "{}") -> dict:
    res = subprocess.run(
        [sys.executable, "-c", RUN_TINY, name, arch, cfg,
         json.dumps(DECODE_TINY), traced], cwd=cwd,
        env=dict(_env(), PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(cwd)])),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax():
    got = _run_tiny(ROOT, "internlm2-decode-32k", "internlm2-1.8b", "0")
    assert got["forbidden"] == [] and got["correct"]


def test_run_py_refuses_without_a_card_or_without_the_program(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "internlm2-decode-32k", "--seed", "5", "--seconds", "1",
           "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copytree(BENCH, tmp_path / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_a_configuration_and_a_metric_are_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "perfbench")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "configs" / "internlm2-1.8b.json").read_text())
    new_cfg = dict(base, name="internlm2-1.8b-12l", reduced=["n_layers"],
                   published={"n_layers": 24},
                   config=dict(base["config"], n_layers=12))
    (tmp_path / "perfbench/configs/internlm2-1.8b-12l.json").write_text(
        json.dumps(new_cfg))
    wl = json.loads((BENCH / "workloads/internlm2-decode-32k.json")
                    .read_text())
    (tmp_path / "perfbench/workloads/internlm2-12l-decode.json").write_text(
        json.dumps(dict(wl, config="internlm2-1.8b-12l", batch=3)))
    (tmp_path / "perfbench/metrics/steps_seen.decode.py").write_text(
        "def read(view):\n    return float(view.steps)\n")
    manifest["configs"].append(dict(
        manifest["configs"][0], name="internlm2-1.8b-12l",
        file="perfbench/configs/internlm2-1.8b-12l.json",
        reduced=["n_layers"]))
    manifest["workloads"].append(dict(
        manifest["workloads"][0], name="internlm2-12l-decode",
        config="internlm2-1.8b-12l", traffic="decode-b3"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "internlm2-decode-32k" in m.get("workloads", []):
            m["workloads"].append("internlm2-12l-decode")
    manifest["per_layer"].append(dict(
        name="steps_seen.decode", unit="steps", better="higher",
        source="host_clock", layer="step driver", moves="tok_s.decode",
        workloads=["internlm2-12l-decode"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "src").symlink_to(ROOT / "src")
    got = _run_tiny(tmp_path, "internlm2-12l-decode", "internlm2-1.8b", "1")
    assert "steps_seen.decode" in got["metrics"] and got["correct"]
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


LAYOUT = """from perfbench.reference.layouts import dense

leaf_shapes, layer = dense.leaf_shapes, dense.layer


def init_scale(cfg, path):
    scale = dense.init_scale(cfg, path)
    return 0.5 if path == "embed.table" else scale
"""


def test_a_layout_is_a_new_file(tmp_path):
    """A configuration of another layout names its module in its file,
    and the weights and the reference follow it: one new file, none
    edited."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "perfbench")
    (tmp_path / "perfbench/reference/layouts/half_embed.py").write_text(
        LAYOUT)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "src").symlink_to(ROOT / "src")
    got = _run_tiny(tmp_path, "internlm2-decode-32k", "internlm2-1.8b", "0",
                    json.dumps({"layout": "half_embed"}))
    assert got["correct"]
    assert "perfbench.reference.layouts.half_embed" in got["layouts"]
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
