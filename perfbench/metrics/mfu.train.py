"""mfu.train: the whole step's share of one H100's peak, in percent: the
least time the step's work needs (``perfbench.work``) over the traced
run's mean step time."""
from perfbench import work


def read(view):
    if view.kind != "train" or not view.steps:
        return None
    return 100.0 * work.min_seconds(view.step_work) / view.step_seconds()
