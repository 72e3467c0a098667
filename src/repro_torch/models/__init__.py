"""The model zoo: the config (``config``), layers, the MoE and SSD blocks,
and every family's assembly (``layers``, ``moe``, ``ssm``,
``transformer``), for training and for token-by-token decode."""
