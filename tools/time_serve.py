#!/usr/bin/env python3
"""Time the serve plane's rounds on one card: sequential against concurrent,
and concurrent under settings that tell host contention from the plane's
own work.

    python3 tools/time_serve.py                  # five GE fields at 2^24
    python3 tools/time_serve.py --n-log2 20

One ``RetrievalServer`` (method hb, 4 workers, a pooled contribution budget
of ``chip_smoke.SERVE_POOL_FIELDS`` fields, a ``chip_smoke.SERVE_WINDOW_MS``
batching window, coalescing) is built once; then each setting answers
``chip_smoke.SERVE_ROUNDS`` on fresh sessions of its own (client names
prefixed, closed after), in this order:

  * ``sequential``  — ``handle_inline`` one request after another, on
    sessions without batcher, coalescer or pool (the smoke's reference);
  * ``one-at-a-time`` — each request through the worker pool, waited for
    before the next is submitted: the plane's machinery (batcher windows,
    pool, coalescer) without concurrency;
  * ``concurrent``  — each round's requests submitted at once (the smoke's
    serve path);
  * ``concurrent, switch 0.1 ms`` — the same with the interpreter's thread
    switch interval at 0.1 ms instead of 5 ms (``sys.setswitchinterval``);
  * ``concurrent, 1 intra-op thread`` — the same with
    ``torch.set_num_threads(1)``;

and then ``one-at-a-time`` and ``concurrent`` again under
``torch.profiler`` (CUDA activity only), for the card's busy time: the sum
of the device time of every kernel and copy, which on the one stream the
sessions share is the time the card was not idle.

Printed per setting: each round's seconds, the process's CPU seconds over
the rounds (all threads), each request's ``latency_s``, the card's busy
seconds where profiled, and whether its results equal the sequential ones
(bytes, bitrate, est_errors bit for bit); then the card's nvidia-smi line
and one JSON line, also written to ``build/time_serve.json``
(git-ignored).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)


def _same(got, want) -> bool:
    import numpy as np
    return all(
        g[k] == w[k] for g, w in zip(got, want)
        for k in ("bytes_moved", "bitrate", "guaranteed")) and all(
        np.float64(g["est_errors"][q]).view(np.uint64)
        == np.float64(w["est_errors"][q]).view(np.uint64)
        for g, w in zip(got, want) for q in w["est_errors"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-log2", type=int, default=24)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.data.synthetic import ge_like_fields
    from repro_torch.launch.serve import Request, RetrievalServer
    _, _, smi = smoke.phase_device()
    fields = ge_like_fields(n=1 << args.n_log2, seed=0)
    field_bytes = ((1 << args.n_log2) + 1) * 8
    t0 = time.perf_counter()
    server = RetrievalServer(
        fields, method="hb", workers=4, queue_depth=16,
        contrib_pool_bytes=smoke.SERVE_POOL_FIELDS * field_bytes,
        decode_batch_ms=smoke.SERVE_WINDOW_MS)
    torch.cuda.synchronize()
    print(f"[serve-time] refactor 2^{args.n_log2} x5: "
          f"{time.perf_counter() - t0:.2f}s")
    parts = (server.decode_batcher, server.coalescer, server.contrib_pool)

    def run(prefix, mode, profile=False):
        rounds, results = [], []
        cpu0 = time.process_time()
        prof = None
        if profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        for reqs in smoke.SERVE_ROUNDS:
            named = [Request(f"{prefix}-{c}", list(q), tau)
                     for c, q, tau in reqs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sequential":
                out = [server.handle_inline(r) for r in named]
            elif mode == "one-at-a-time":
                out = [server.handle(r) for r in named]
            else:
                futures = [server.submit(r) for r in named]
                out = [f.result() for f in futures]
            torch.cuda.synchronize()
            rounds.append(time.perf_counter() - t0)
            results.append(out)
        extra = {"cpu_s": time.process_time() - cpu0}
        if prof is not None:
            prof.__exit__(None, None, None)
            extra["device_busy_s"] = sum(
                getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()) / 1e6
        for c in [c for c in server.sessions if c.startswith(prefix + "-")]:
            server.sessions.pop(c).close()
        gc.collect()
        torch.cuda.empty_cache()
        return rounds, results, extra

    report = {"device": smi, "n_log2": args.n_log2, "settings": {}}
    server.decode_batcher = server.coalescer = server.contrib_pool = None
    server.contrib_budget_bytes = smoke.SERVE_BUDGET_FIELDS * field_bytes
    want_rounds, want, extra = run("seq", "sequential")
    (server.decode_batcher, server.coalescer, server.contrib_pool) = parts
    server.contrib_budget_bytes = None
    report["settings"]["sequential"] = {
        "rounds_s": want_rounds, **extra,
        "latency_s": [r["latency_s"] for rr in want for r in rr]}
    switch = sys.getswitchinterval()
    threads = torch.get_num_threads()
    for name, prefix, mode, interval, nthreads, profile in (
            ("one-at-a-time", "one", "one-at-a-time", switch, threads,
             False),
            ("concurrent", "conc", "concurrent", switch, threads, False),
            ("concurrent, switch 0.1 ms", "fast", "concurrent", 1e-4,
             threads, False),
            ("concurrent, 1 intra-op thread", "one-thread", "concurrent",
             switch, 1, False),
            ("one-at-a-time, profiled", "one-prof", "one-at-a-time", switch,
             threads, True),
            ("concurrent, profiled", "conc-prof", "concurrent", switch,
             threads, True)):
        sys.setswitchinterval(interval)
        torch.set_num_threads(nthreads)
        try:
            rounds, got, extra = run(prefix, mode, profile)
        finally:
            sys.setswitchinterval(switch)
            torch.set_num_threads(threads)
        equal = all(_same(g, w) for g, w in zip(got, want))
        report["settings"][name] = {
            "rounds_s": rounds, "equal": equal, **extra,
            "latency_s": [r["latency_s"] for rr in got for r in rr]}
    server.close()
    report["intra_op_threads"] = threads
    for name, r in report["settings"].items():
        print(f"[serve-time] {name}: rounds "
              f"{', '.join(f'{x:.2f}' for x in r['rounds_s'])}s, process "
              f"CPU {r['cpu_s']:.2f}s"
              + (f", card busy {r['device_busy_s']:.2f}s"
                 if "device_busy_s" in r else "")
              + f"; latency_s {[round(x, 3) for x in r['latency_s']]}"
              + (f"; results equal the sequential ones: {r['equal']}"
                 if "equal" in r else ""))
    print(f"[serve-time] torch intra-op threads {threads}")
    line = json.dumps(report)
    dump = ROOT / "build" / "time_serve.json"
    dump.parent.mkdir(exist_ok=True)
    dump.write_text(line)
    print(smi)
    print(line)
    if not all(r.get("equal", True) for r in report["settings"].values()):
        raise AssertionError("a setting's results differ from the "
                             "sequential ones")
    return 0


if __name__ == "__main__":
    sys.exit(main())
