"""GE CFD case study (paper §VI) on the PyTorch/CUDA port: all six QoIs
Eq.(1)-(6) across a ladder of tolerances, comparing the three progressive
representations.  The counterpart of ``ge_case_study.py``: the same calls
at the same size, the same lines.

    PYTHONPATH=src python examples/ge_case_study_torch.py
    PYTHONPATH=src python examples/ge_case_study_torch.py --device cpu

Runs on CUDA unless ``--device cpu`` is given.  Exits non-zero unless every
request converges with each actual error within its estimate and each
estimate within its tolerance.
"""
import argparse

import torch

import repro_torch
from repro_torch.core import QoIRequest, ge, retrieve_qoi_controlled
from repro_torch.data.synthetic import ge_like_fields

METHODS = ("hb", "psz3_delta", "psz3")
TAUS = (1e-2, 1e-4, 1e-6)


def main(device=None, n=1 << 15):
    """Run the case study; returns the numbers it prints, one record per
    method and tolerance."""
    fields = ge_like_fields(n=n, seed=0)
    qois = ge.all_qois()
    records = []
    for method in METHODS:
        archive = repro_torch.refactor(fields, method=method, device=device)
        orig = {k: torch.from_numpy(v).to(archive.device)
                for k, v in fields.items()}
        truth = {k: e.value(orig) for k, e in qois.items()}
        print(f"\n=== {method} (archive "
              f"{archive.total_nbytes / 2**20:.2f} MiB) ===")
        session = archive.open()   # one progressive session, tau tightening
        for tau in TAUS:
            reqs = [QoIRequest(k, e, tau) for k, e in qois.items()]
            res = retrieve_qoi_controlled(session, reqs)
            actual = {k: float((truth[k] - e.value(res.values)).abs().max())
                      for k, e in qois.items()}
            worst = max(actual[k] / res.tau_abs[k] for k in qois)
            print(f"tau={tau:.0e}: bitrate={res.bitrate:6.2f} b/elem "
                  f"bytes={res.bytes_retrieved:>9d} "
                  f"worst actual/tau={worst:.3f} "
                  f"guaranteed={res.converged}")
            if not res.converged:
                raise AssertionError(f"{method} tau={tau}: not converged")
            for k in qois:
                if not actual[k] <= res.est_errors[k] <= res.tau_abs[k]:
                    raise AssertionError(
                        f"{method} tau={tau} {k}: actual {actual[k]}, "
                        f"estimate {res.est_errors[k]}, tolerance "
                        f"{res.tau_abs[k]}")
            records.append({"method": method, "tau": tau,
                            "archive_bytes": archive.total_nbytes,
                            "bytes_retrieved": res.bytes_retrieved,
                            "bitrate": res.bitrate,
                            "est_errors": dict(res.est_errors),
                            "tau_abs": dict(res.tau_abs),
                            "actual_errors": actual,
                            "converged": res.converged})
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
