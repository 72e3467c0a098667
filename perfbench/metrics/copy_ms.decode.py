"""copy_ms.decode: device milliseconds a step in copy kernels (the frozen
table's ``copy`` class), which at long context are the K/V layout copies
of the attention over the cache."""


def read(view):
    if view.kind != "decode" or not view.steps:
        return None
    return 1e3 * view.class_seconds().get("copy", 0.0) / view.steps
