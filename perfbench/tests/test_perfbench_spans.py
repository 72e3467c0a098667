"""The readers of the program's spans and counters on the CPU: each from a
hand-built ``View`` and hand-built records gives the number worked out by
hand, and ``None`` for the other kind of cell, without spans, or with a
program that has none; the attention's bytes are the K/V term of the
decode step's work; and the expert counter is the count of the pairs the
dispatch keeps, recomputed from the router's choices, for every dispatch,
with and without drops."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import bench, trace, work  # noqa: E402
from repro_torch import configs, spans  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

MS = 1e6        # nanoseconds in a millisecond


def reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def view(kind: str, steps: int = 2, dev=(), host=()) -> trace.View:
    return trace.View(list(dev), list(host), 0, 100 * MS, kind, steps,
                      0.1, {})


def rec(name: str, device_ms=1.0, t0=MS, t1=2 * MS, **attrs):
    return spans.Record(spans.PREFIX + name, None, 0, attrs, t0, t1,
                        device_ms)


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers these records as the program's."""
    def give(*recs):
        monkeypatch.setattr(spans, "records", lambda: list(recs))
    return give


def share(flops, nbytes, device_s):
    return 100.0 * max(flops / 989e12, nbytes / 3.35e12) / device_s


ATTEND = dict(B=2, T=100, H=4, K=2, hd=8, cache="bfloat16", pos=49)


def test_attn_roofline(recorded):
    r = reader("attn_roofline.decode")
    recorded(rec("attend", 1e-3, **ATTEND),
             rec("attend", 3e-3, **dict(ATTEND, pos=150, cache="int8")),
             rec("attend", 5.0, t0=101 * MS, t1=102 * MS, **ATTEND),
             rec("experts", 1.0))
    # valid 50: 4·8·4·2·50 FLOPs, 2·2·50·2·8 bf16; valid 100 (pos past T),
    # int8 codes and float32 scales
    bf16 = max(12800 / 989e12, 6400 / 3.35e12)
    int8 = max(25600 / 989e12, (800 * 8 + 800 * 4) / 3.35e12)
    assert r.read(view("decode")) == pytest.approx(
        100.0 * (bf16 + int8) / 4e-6)
    assert r.read(view("train")) is None


def test_experts_roofline_and_fill(recorded):
    r, fill = reader("experts_roofline.decode"), reader(
        "expert_fill_pct.decode")
    attrs = dict(E=4, C=8, d=16, d_ff=32, dtype="bfloat16",
                 weights="float32",
                 kept=torch.tensor([True, True, False, True, True]),
                 expert=torch.tensor([0, 2, 3, 2, 2]))
    onehot = dict(attrs, kept=torch.tensor(
        [[True, False], [False, False], [False, True]]).unsqueeze(-1)
        .expand(3, 2, 4) & (torch.arange(4) == 1),
        expert=torch.tensor([[1, 0], [2, 3], [0, 1]]))
    recorded(rec("experts", 2e-3, **attrs), rec("experts", 2e-3, **onehot),
             rec("attend", 1.0, **ATTEND))
    # 4 kept pairs over experts {0, 2}; 2 kept pairs over expert {1}
    a = max(6 * 16 * 32 * 4 / 989e12, (2 * 3 * 16 * 32 * 4
                                       + 2 * 4 * 16 * 2) / 3.35e12)
    b = max(6 * 16 * 32 * 2 / 989e12, (1 * 3 * 16 * 32 * 4
                                       + 2 * 2 * 16 * 2) / 3.35e12)
    assert r.read(view("decode")) == pytest.approx(100.0 * (a + b) / 4e-6)
    assert fill.read(view("decode")) == pytest.approx(100.0 * 6 / 64)
    assert r.read(view("train")) is None and fill.read(view("train")) is None


LEAVES = [(1000, "bfloat16", "bfloat16"), (10, "float32", "bfloat16")]


def test_adamw_and_compress_rooflines(recorded):
    adamw, comp = reader("adamw_roofline.train"), reader(
        "compress_roofline.train")
    recorded(rec("adamw", 0.5, leaves=LEAVES),
             rec("compress", 0.25, k_planes=8,
                 leaves=[(n, g) for n, _, g in LEAVES]))
    assert adamw.read(view("train")) == pytest.approx(share(
        0, 1000 * (4 + 2 + 16) + 10 * (8 + 2 + 16), 0.5e-3))
    assert comp.read(view("train")) == pytest.approx(share(
        0, 1000 * (4 + 8) + 10 * (4 + 8), 0.25e-3))
    assert adamw.read(view("decode")) is None
    assert comp.read(view("decode")) is None


SPAN_READERS = ["attn_roofline.decode", "experts_roofline.decode",
                "expert_fill_pct.decode", "adamw_roofline.train",
                "compress_roofline.train"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_no_spans_read_none(name, recorded, monkeypatch):
    r = reader(name)
    kind = name.rsplit(".", 1)[1]
    recorded()
    assert r.read(view(kind)) is None
    # a span off the card has no device time; a program without spans
    recorded(rec("attend", None, **ATTEND),
             rec("adamw", None, leaves=LEAVES),
             rec("compress", None, k_planes=8, leaves=[(1, "float32")]))
    assert r.read(view(kind)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "spans")
    assert r.read(view(kind)) is None


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_step_idle(kind):
    r = reader(f"step_idle_ms.{kind}")
    step = spans.PREFIX + ("serve_step" if kind == "decode" else
                           "train_step")
    dev = [(10 * MS, 20 * MS, "k", "kernel"), (25 * MS, 40 * MS, "k",
                                               "kernel"),
           (60 * MS, 70 * MS, "c", "memcpy")]
    host = [(5 * MS, 30 * MS, step), (12 * MS, 13 * MS, "aten::mm"),
            (35 * MS, 65 * MS, step), (95 * MS, 130 * MS, step)]
    # idle inside the steps: 5-10, 20-25; 40-60; 95-100 (the window's end)
    assert r.read(view(kind, steps=4, dev=dev, host=host)) == \
        pytest.approx((5 + 5 + 20 + 5) / 4)
    other = "train" if kind == "decode" else "decode"
    assert r.read(view(other, dev=dev, host=host)) is None
    assert r.read(view(kind, dev=dev, host=host[1:2])) is None
    assert r.read(view(kind, host=host)) is None


def _config(arch: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{arch}.json")
                      .read_text())["config"]


@pytest.mark.parametrize("arch,batch,valid,slots", [
    ("internlm2-1.8b", 16, 28_673, 32_768),
    ("olmoe-1b-7b", 64, 3_585, 4_096)])
def test_attention_bytes_are_the_decode_step_s_k_v_term(arch, batch, valid,
                                                       slots):
    cfg = _config(arch)
    attrs = dict(B=batch, T=slots, H=cfg["n_heads"], K=cfg["n_kv_heads"],
                 hd=cfg["head_dim"], cache=cfg["dtype"], pos=valid - 1)
    least = reader("attn_roofline.decode").least(attrs)
    kv = work.decode_step_work(cfg, batch, valid)["bytes"] - \
        work.decode_step_work(cfg, batch, 0)["bytes"]
    assert cfg["n_layers"] * least["bytes"] == pytest.approx(kv, rel=1e-12)


@pytest.mark.parametrize("dispatch", ["scatter", "sort", "onehot"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_the_expert_counter_is_the_router_s(dispatch, capacity_factor,
                                            monkeypatch):
    """The pairs the dispatch keeps, as the spans record them, against a
    count from the router's choices: min(tokens routed to e, C) kept for
    each expert e.  At capacity factor 0.5 every expert drops pairs."""
    cfg = dataclasses.replace(configs.get_reduced("olmoe-1b-7b"),
                              capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(5)
    p = M.init_moe(gen, cfg, torch.device("cpu"))
    x = torch.randn((64, 1, cfg.d_model), generator=gen)
    _, gate_idx, _ = M.route(p, cfg, x.reshape(64, cfg.d_model))
    cap = M._capacity(cfg, 64)
    routed = torch.bincount(gate_idx.reshape(-1), minlength=cfg.n_experts)
    kept = int(torch.clamp_max(routed, cap).sum())
    assert capacity_factor > 1 or kept < routed.sum()
    monkeypatch.setattr(spans, "_session", spans._Session(open=False))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        M.moe_block(p, cfg, x, dispatch=dispatch)
    (r,) = [r for r in spans.records() if r.name.endswith("experts")]
    assert reader("experts_roofline.decode").pairs(r.attrs) == (
        kept, int((routed > 0).sum()))
    v = view("decode")
    v.lo, v.hi = r.t0, r.t1
    assert reader("expert_fill_pct.decode").read(v) == pytest.approx(
        100.0 * kept / (cfg.n_experts * cap))


def test_every_new_reader_is_a_metric_of_the_benchmark():
    names = {m["name"] for m in bench.load_json(ROOT / "BENCHMARK.json")
             ["per_layer"]}
    assert set(SPAN_READERS) | {"step_idle_ms.decode",
                                "step_idle_ms.train"} <= names
