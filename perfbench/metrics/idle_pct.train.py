"""idle_pct.train: the share of the traced window, in percent, in which no
operation ran on the device (the union of the device's operations)."""


def read(view):
    if view.kind != "train":
        return None
    return 100.0 * view.idle_share()
