"""``repro_torch.spans`` on the CPU: with no profiler the spans enter no
``record_function`` and record nothing; under ``torch.profiler`` a reduced
internlm2 and olmoe decode step and a reduced internlm2 train step give
the span tree the program marks (names, parents, one step id per root,
attributes equal to the inputs' shapes), the same ``aten::`` ops as with
the gate forced off, and host ranges on the profiler's own clock."""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, spans
from repro_torch.data.batches import make_train_batch
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer
from repro_torch.train.grad_compress import compress_decompress, \
    zeros_like_feedback
from repro_torch.train.pytree import tree_leaves
from repro_torch.train.train_step import make_serve_step, make_train_step

B, MAX_SEQ, STEPS = 3, 8, 2
KINDS = [("internlm2-1.8b", "decode"), ("olmoe-1b-7b", "decode"),
         ("internlm2-1.8b", "train")]


def _run(arch: str, kind: str):
    """A closure running ``STEPS`` reduced steps from the same start each
    call, and the model's parameters."""
    cfg = configs.get_reduced(arch)
    params = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu").tree()
    if kind == "decode":
        step = make_serve_step(cfg)

        def go():
            state = T.init_decode_state(cfg, B, MAX_SEQ, device="cpu")
            tok = torch.arange(B, dtype=torch.int32).view(B, 1)
            for _ in range(STEPS):
                _, state = step(params, state, tok)
        return cfg, params, go
    fb = zeros_like_feedback(params)
    init, step = make_train_step(
        cfg, lr=1e-3, grad_transform=lambda g: compress_decompress(
            g, fb, 8)[0])
    batch = make_train_batch(cfg, 2, 16, device="cpu")

    def go():
        p = {k: v for k, v in params.items()}
        opt = init(p)
        for _ in range(STEPS):
            p, opt, _ = step(p, opt, batch)
    return cfg, params, go


def _profiled(go):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.live()
        go()
    assert not spans.live()
    return prof, spans.records()


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(spans, "_session", spans._Session(open=False))


@pytest.mark.parametrize("arch,kind", KINDS)
def test_no_profiler_records_nothing(arch, kind, fresh, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span went live with no profiler")
    monkeypatch.setattr(spans, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _, _, go = _run(arch, kind)
    assert not spans.live()
    go()
    assert spans.records() == []
    assert spans.span("attend") is spans.span("experts")


def _tree(recs):
    return [(r.name.removeprefix(spans.PREFIX), r.parent, r.step)
            for r in recs]


@pytest.mark.parametrize("arch,kind", KINDS)
def test_profiled_steps_give_the_span_tree(arch, kind, fresh):
    cfg, params, go = _run(arch, kind)
    _, recs = _profiled(go)
    want = []
    for s in range(STEPS):
        root = len(want)
        if kind == "decode":
            want.append(("serve_step", None, s))
            for _ in range(cfg.n_layers):
                want.append(("attend", root, s))
                if cfg.n_experts:
                    want.append(("experts", root, s))
        else:
            want += [("train_step", None, s), ("compress", root, s),
                     ("adamw", root, s)]
    assert _tree(recs) == want
    sizes = [p.numel() for p in tree_leaves(params)]
    dt = str(cfg.dtype)
    for r in recs:
        a = r.attrs
        assert r.t0 < r.t1 and r.device_ms is None
        if r.name.endswith("serve_step"):
            assert a == {"batch": B}
        elif r.name.endswith("attend"):
            assert a == {"B": B, "T": MAX_SEQ, "H": cfg.n_heads,
                         "K": cfg.n_kv_heads, "hd": cfg.head_dim,
                         "cache": dt, "pos": r.step}
        elif r.name.endswith("experts"):
            pairs = B * cfg.top_k
            assert {k: a[k] for k in ("E", "C", "d", "d_ff", "dtype",
                                      "weights")} == {
                "E": cfg.n_experts, "C": M._capacity(cfg, B),
                "d": cfg.d_model, "d_ff": cfg.d_ff, "dtype": dt,
                "weights": str(cfg.param_dtype)}
            assert a["kept"].shape == a["expert"].shape == (pairs,)
            assert a["kept"].dtype == torch.bool
        elif r.name.endswith("train_step"):
            assert a == {"batch": 2, "seq": 16}
        elif r.name.endswith("compress"):
            assert a == {"k_planes": 8, "leaves": [(n, dt) for n in sizes]}
        else:
            assert a == {"leaves": [(n, dt, dt) for n in sizes]}


def test_a_new_profiler_session_starts_a_new_buffer(fresh):
    _, _, go = _run("internlm2-1.8b", "decode")
    first = _profiled(go)[1]
    second = _profiled(go)[1]
    assert len(first) == len(second) and first[0] is not second[0]
    assert spans.records() == second


def _aten(prof) -> Counter:
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("aten::"))


@pytest.mark.parametrize("arch,kind", KINDS)
def test_the_spans_add_no_op(arch, kind, fresh, monkeypatch):
    _, _, go = _run(arch, kind)
    live = _aten(_profiled(go)[0])
    monkeypatch.setattr(spans, "live", lambda: False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go()
    assert live == _aten(prof) and live


@pytest.mark.parametrize("arch,kind", KINDS)
def test_the_profiler_s_ranges_lie_inside_the_records(arch, kind, fresh):
    _, _, go = _run(arch, kind)
    prof, recs = _profiled(go)
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in
                    prof.profiler.kineto_results.events()
                    if e.name().startswith(spans.PREFIX))
    assert [n for *_, n in ranges] == [r.name for r in recs]
    for (s, e, _), r in zip(ranges, recs):
        assert r.t0 <= s <= e <= r.t1
        assert s - r.t0 < 1_000_000 and r.t1 - e < 1_000_000
