"""Share of the window in which no device operation ran:
1 minus the union of all device intervals in the trace over the
window."""


def read(run):
    busy = run.busy_s()
    if busy is None or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.seconds)
