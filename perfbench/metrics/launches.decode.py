"""launches.decode: kernel launches a step, the device's kernel events in the
traced window over the steps completed."""


def read(view):
    if view.kind != "decode" or not view.steps:
        return None
    return len(view.kernels()) / view.steps
