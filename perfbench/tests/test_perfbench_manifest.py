"""``BENCHMARK.json`` against the benchmark's contract: names, units and
lengths, every metric reported where its end-to-end metric is, every
configuration used and held to the program's registry, every cell with its
files, the check's limits and the time a full check takes; and the work
arithmetic against the program's analytic model."""
from __future__ import annotations

import dataclasses
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import work  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_units_and_lengths():
    assert set(MANIFEST) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
        for e in MANIFEST[group]:
            assert set(e) - {"workloads"} == KEYS[group], e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    metrics = [m["name"] for m in MANIFEST["end_to_end"] +
               MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(_line(w) for w in MANIFEST["command"])
    assert len(MANIFEST["command"]) <= 32


def test_paths_hold_the_command_and_every_file():
    paths = MANIFEST["paths"]
    assert paths == ["perfbench"]
    assert MANIFEST["command"][1].startswith("perfbench/")
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


def test_bounds_sources_and_run_length():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_its_metrics():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(cells)
        for cell in m["workloads"]:
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for cell, w in cells.items():
        assert w["chips"] in (1, 4) and _line(w["why"])
        others = [m for m in e2e.values() if m["name"] != "setup_s"
                  and reports(m, cell)]
        assert others, cell
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
        wl = json.loads((ROOT / "perfbench" / "workloads" /
                         f"{cell}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" / f"{wl['kind']}.py").exists()
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)


def test_every_configuration_is_used_and_is_the_registry_s():
    from repro_torch import configs
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        published = dataclasses.asdict(configs.get(data["registry"]))
        for key, value in published.items():
            if key in c["reduced"]:
                assert data["published"][key] == value
                assert data["config"][key] != value
            else:
                assert data["config"][key] == value, (c["name"], key)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_parameter_counts_are_the_analytic_model_s(arch):
    """Counted from the layout's shapes, they equal the program's analytic
    model's, counted from ``init_params``' shapes, at the full configs."""
    from repro_torch import configs
    from repro_torch.launch import analytic
    cfg = configs.get(arch)
    mine = work.param_counts(dataclasses.asdict(cfg))
    theirs = analytic.param_counts(cfg)
    for key in ("total", "embed", "expert", "active", "head"):
        assert mine[key] == theirs[key], key


def _shape(kind: str, batch: int, seq: int):
    from repro_torch.models.config import ShapeSpec
    return ShapeSpec(name=f"{kind}_{seq}", kind=kind, seq_len=seq,
                     global_batch=batch)


@pytest.mark.parametrize("arch,train,decode", [
    ("internlm2-1.8b", (2, 4096), (16, 28_800)),
    ("olmoe-1b-7b", (2, 4096), (64, 3_840))])
def test_a_step_s_work_is_the_analytic_count_term_by_term(arch, train,
                                                           decode):
    """The step's least work against the program's analytic model, term by
    term: its products less the norms (no product), causal attention, one
    half of the full T×T plus the diagonal, and in decode both K and V
    over the valid slots and one written, the head and the experts a
    batch reaches in place of the embedding table and top_k of n."""
    from repro_torch import configs
    from repro_torch.launch import analytic
    cfg = configs.get(arch)
    mine = dataclasses.asdict(cfg)
    norms = work.param_counts(mine)["norms"]
    b, s = train
    sh = _shape("train", b, s)
    want = analytic.model_flops(cfg, sh) - 6 * b * s * norms + \
        analytic.attention_flops(cfg, sh) * (s + 1) / (2 * s)
    assert work.train_step_work(mine, b, s)["flops"] == \
        pytest.approx(want, rel=1e-12)
    b, valid = decode
    got = work.decode_step_work(mine, b, valid)
    sh = _shape("decode", b, valid)
    want = analytic.model_flops(cfg, sh) - 2 * b * norms + \
        analytic.attention_flops(cfg, sh)
    assert got["flops"] == pytest.approx(want, rel=1e-12)
    counts = analytic.param_counts(cfg)
    hbm = analytic.hbm_bytes(cfg, _shape("decode", b, valid + 1), 1)
    if cfg.n_experts:
        k = cfg.top_k / cfg.n_experts
        weights = hbm["weights"] + 2 * counts["head"] + 2 * \
            counts["expert"] * ((1 - (1 - k) ** b) - k)
    else:
        weights = hbm["weights"] - 2 * (counts["embed"] - counts["head"])
    want = weights + 2 * hbm["kv_cache"] + b * cfg.d_model * 2 + \
        b * cfg.vocab * 2
    assert got["bytes"] == pytest.approx(want, rel=1e-12)
    assert work.min_seconds(got) == max(got["flops"] / work.PEAK_BF16_FLOPS,
                                        got["bytes"] / work.PEAK_HBM_BYTES)
