"""Entry points of the port: ``serve`` (the concurrent retrieval server),
``train`` (the training entry point with progressive checkpoints), and the
launch tools -- ``mesh`` (device meshes, the production meshes over a fake
process group), ``dryrun``, ``diag`` and ``grad_sync_dryrun`` (steps traced
on fake tensors), ``hlo_analysis`` (the per-device op counter) and
``analytic`` (the napkin FLOPs and bytes model)."""
