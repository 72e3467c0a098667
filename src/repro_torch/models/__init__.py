"""The model zoo's training path: the config (``config``), layers, the MoE
and SSD blocks, and every family's assembly (``layers``, ``moe``, ``ssm``,
``transformer``)."""
