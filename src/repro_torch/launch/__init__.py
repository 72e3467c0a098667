"""Entry points of the port: ``serve`` (the concurrent retrieval server)."""
