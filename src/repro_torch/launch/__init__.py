"""Entry points of the port: ``serve`` (the concurrent retrieval server)
and ``train`` (the training driver with progressive checkpoints)."""
