"""The port's pipeline examples (``examples/quickstart_torch.py``,
``examples/ge_case_study_torch.py``) on the CPU against the reference
pipeline, run by hand with the same calls at the same size: archive bytes,
bytes retrieved, iterations, est_errors, tau_abs and actual errors equal.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro._x64  # noqa: E402,F401  (float64 in the reference)
from repro.core import ge as jge  # noqa: E402
from repro.core.refactor import refactor_variables as jax_refactor  # noqa: E402
from repro.core.retrieval import QoIRequest as JaxQoIRequest  # noqa: E402
from repro.core.retrieval import retrieve_qoi_controlled as jax_retrieve  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JaxActual:
    """max |QoI(original) - QoI(reconstruction)| in the reference, compiled:
    the port evaluates QoIs with the roundings of ``jax.jit`` (ROADMAP C3),
    not with those of eager jnp calls.  One compiled function and one
    truth per QoI."""

    def __init__(self, qois, orig):
        self.value = {k: jax.jit(e.value) for k, e in qois.items()}
        self.truth = {k: np.asarray(f(orig)) for k, f in self.value.items()}

    def __call__(self, values) -> dict:
        return {k: float(np.abs(self.truth[k]
                                - np.asarray(f(values))).max())
                for k, f in self.value.items()}


N_EXAMPLE = 1 << 10


def test_quickstart_example_equals_the_reference_pipeline(capsys):
    got = _example("quickstart_torch").main(device=CPU, n=N_EXAMPLE)
    out = capsys.readouterr().out
    assert "within estimate: True" in out and "within estimate: False" \
        not in out
    fields = jsyn.ge_like_fields(n=N_EXAMPLE, seed=0)
    archive = jax_refactor(fields, method="hb")
    session = archive.open()
    qois = {"VTOT": jge.v_total(), "Mach": jge.mach()}
    res = jax_retrieve(session, [JaxQoIRequest(k, e, tau_rel=1e-4)
                                 for k, e in qois.items()])
    assert got["archive_bytes"] == archive.total_nbytes
    assert got["bytes_retrieved"] == res.bytes_retrieved
    assert got["iterations"] == len(res.iterations)
    assert got["est_errors"] == res.est_errors
    assert got["tau_abs"] == res.tau_abs
    orig = {k: np.asarray(v) for k, v in fields.items()}
    assert got["actual_errors"] == _JaxActual(qois, orig)(res.values)
    before = session.bytes_retrieved
    res2 = jax_retrieve(session, [JaxQoIRequest("VTOT", jge.v_total(),
                                                tau_rel=1e-6)])
    assert got["tight_bytes_moved"] == session.bytes_retrieved - before
    assert got["tight_est_errors"] == res2.est_errors


def test_ge_case_study_example_equals_the_reference_pipeline(capsys):
    mod = _example("ge_case_study_torch")
    got = mod.main(device=CPU, n=N_EXAMPLE)
    assert "guaranteed=False" not in capsys.readouterr().out
    fields = jsyn.ge_like_fields(n=N_EXAMPLE, seed=0)
    orig = {k: np.asarray(v) for k, v in fields.items()}
    qois = jge.all_qois()
    actual = _JaxActual(qois, orig)
    want = []
    for method in mod.METHODS:
        archive = jax_refactor(fields, method=method)
        session = archive.open()
        for tau in mod.TAUS:
            res = jax_retrieve(session, [JaxQoIRequest(k, e, tau)
                                         for k, e in qois.items()])
            want.append((method, tau, archive.total_nbytes,
                         res.bytes_retrieved, res.est_errors, res.tau_abs,
                         actual(res.values), res.converged))
    assert [(r["method"], r["tau"], r["archive_bytes"],
             r["bytes_retrieved"], r["est_errors"], r["tau_abs"],
             r["actual_errors"], r["converged"]) for r in got] == want
