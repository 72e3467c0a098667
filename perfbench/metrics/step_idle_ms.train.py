"""step_idle_ms.train: device-idle milliseconds a step while the program's
step is open on the host: the parts of the traced window with no
operation on the device (outside ``view.busy``) that fall inside a
``repro_torch.train_step`` range of the profiler's host events, over the
steps completed.  Read from the trace alone, on the profiler's clock.
``None`` where the program records no such range, or the window holds no
device operation."""
import bisect

SPAN = "repro_torch.train_step"


def idle_ns(view, name: str) -> int:
    """Nanoseconds of the window outside ``view.busy`` inside host
    ranges named ``name`` (which do not overlap: one step at a time)."""
    busy, total = view.busy, 0
    for s, e, n in view.host:
        s, e = max(s, view.lo), min(e, view.hi)
        if n != name or e <= s:
            continue
        total += e - s
        i = max(bisect.bisect_right(busy, (s,)) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            total -= max(0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
    return total


def read(view):
    if view.kind != "train" or not view.steps or not view.ops:
        return None
    if not any(n == SPAN for _, _, n in view.host):
        return None
    return idle_ns(view, SPAN) / 1e6 / view.steps
