"""Window loops, one module per workload kind (``decode``, ``train``)."""
