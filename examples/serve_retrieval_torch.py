"""Progressive-retrieval service demo on the PyTorch/CUDA port: concurrent
client requests through the serve plane (worker pool, coalescing, pooled
contribution budget, batched decode), as ``examples/serve_retrieval.py``
drives the JAX package (see src/repro_torch/launch/serve.py).

    PYTHONPATH=src python examples/serve_retrieval_torch.py              # CUDA
    PYTHONPATH=src python examples/serve_retrieval_torch.py --device cpu
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--n", str(1 << 15), "--requests", "12", "--workers", "4",
          "--pool-mb", "64", "--batch-window-ms", "2", *sys.argv[1:]])
