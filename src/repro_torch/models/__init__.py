"""The model zoo's training path: configs (``config``), layers and the
dense family's assembly (``layers``, ``transformer``)."""
