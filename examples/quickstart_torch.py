"""Quickstart on the PyTorch/CUDA port: refactor scientific data once,
retrieve progressively with a guaranteed QoI error bound.  The counterpart
of ``quickstart.py``: the same calls at the same size, the same lines.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on CUDA unless ``--device cpu`` is given.  Exits non-zero unless every
actual error is within its estimate and every estimate within its
tolerance.
"""
import argparse

import torch

import repro_torch
from repro_torch.core import QoIRequest, ge, retrieve_qoi_controlled
from repro_torch.data.synthetic import ge_like_fields


def main(device=None, n=1 << 15):
    """Run the quickstart; returns the numbers it prints."""
    # 1. "simulation output": velocity + pressure + density fields
    fields = ge_like_fields(n=n, seed=0)
    raw_mib = sum(v.nbytes for v in fields.values()) / 2 ** 20

    # 2. refactor once into progressive bitplane segments (PMGARD-HB)
    archive = repro_torch.refactor(fields, method="hb", device=device)
    print(f"raw {raw_mib:.2f} MiB -> archive "
          f"{archive.total_nbytes / 2**20:.2f} MiB (full precision)")

    # 3. progressive, QoI-error-controlled retrieval: total velocity and
    #    Mach number to 1e-4 relative error — guaranteed, without ever
    #    seeing the original data
    session = archive.open()
    qois = {"VTOT": ge.v_total(), "Mach": ge.mach()}
    result = retrieve_qoi_controlled(
        session, [QoIRequest(k, e, tau_rel=1e-4) for k, e in qois.items()])
    print(f"retrieved {result.bytes_retrieved / 2**20:.2f} MiB "
          f"({result.bitrate:.2f} bits/elem) in "
          f"{len(result.iterations)} round(s)")
    for name in qois:
        print(f"  {name}: estimated error {result.est_errors[name]:.3e} "
              f"<= tolerance {result.tau_abs[name]:.3e}")

    # 4. verify against the original (possible offline only)
    truth_in = {k: torch.from_numpy(v).to(archive.device)
                for k, v in fields.items()}
    actual = {}
    for name, expr in qois.items():
        err = (expr.value(truth_in) - expr.value(result.values)).abs().max()
        actual[name] = float(err)
        ok = actual[name] <= result.est_errors[name]
        print(f"  {name}: actual error {actual[name]:.3e} "
              f"(within estimate: {ok})")

    # 5. tighten the tolerance — only NEW segments move (progressive!)
    before = session.bytes_retrieved
    result2 = retrieve_qoi_controlled(
        session, [QoIRequest("VTOT", ge.v_total(), tau_rel=1e-6)])
    moved = session.bytes_retrieved - before
    print(f"tightening VTOT to 1e-6 moved only "
          f"{moved / 2**20:.2f} MiB more")

    for res, names in ((result, qois), (result2, ("VTOT",))):
        if not res.converged:
            raise AssertionError(f"{list(names)} did not converge")
        for name in names:
            if not res.est_errors[name] <= res.tau_abs[name]:
                raise AssertionError(f"{name}: estimate "
                                     f"{res.est_errors[name]} > tolerance "
                                     f"{res.tau_abs[name]}")
    for name in qois:
        if not actual[name] <= result.est_errors[name]:
            raise AssertionError(f"{name}: actual error {actual[name]} > "
                                 f"estimate {result.est_errors[name]}")
    return {"archive_bytes": archive.total_nbytes,
            "bytes_retrieved": result.bytes_retrieved,
            "iterations": len(result.iterations),
            "est_errors": dict(result.est_errors),
            "tau_abs": dict(result.tau_abs),
            "actual_errors": actual,
            "tight_bytes_moved": moved,
            "tight_est_errors": dict(result2.est_errors)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
