"""The paper's algorithms on tensors: refactor (Alg. 1), QoI expressions
and estimators (Thms 1-9), and QoI-controlled retrieval (Algs 2-4).

Counterpart of ``repro/core/__init__.py``, with the same exports.  The
reference switches jax to float64 here; the port states ``float64`` on
every tensor it makes, so it needs no switch."""
from repro_torch.core import estimators
from repro_torch.core.qoi import (
    Const,
    Expr,
    IntPow,
    Prod,
    Quot,
    Radical,
    Sqrt,
    Sum,
    Var,
    frac_pow,
    magnitude,
    scale,
    square,
)
from repro_torch.core.retrieval import (
    QoIRequest,
    RetrievalResult,
    assign_eb,
    retrieve_qoi_controlled,
)
from repro_torch.core.refactor import refactor_variables

__all__ = [
    "estimators",
    "Expr", "Var", "Const", "Sum", "Prod", "Quot", "IntPow", "Sqrt", "Radical",
    "scale", "square", "magnitude", "frac_pow",
    "QoIRequest", "RetrievalResult", "assign_eb", "retrieve_qoi_controlled",
    "refactor_variables",
]
