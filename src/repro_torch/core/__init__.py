"""The paper's algorithms on tensors: refactor (Alg. 1), QoI expressions
and estimators (Thms 1-9), and QoI-controlled retrieval (Algs 2-4)."""
