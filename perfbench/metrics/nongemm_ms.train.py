"""nongemm_ms.train: device milliseconds a step outside matrix-product
kernels (every class of the frozen table but ``matmul``)."""


def read(view):
    if view.kind != "train" or not view.steps:
        return None
    secs = view.class_seconds()
    return 1e3 * (sum(secs.values()) - secs.get("matmul", 0.0)) / view.steps
