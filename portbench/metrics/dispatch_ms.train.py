"""Host time a step spends inside the trainer's step call (issuing the
step, and every wait inside it), the trainer's ``dispatch_s``."""


def read(run):
    steps = run.counters.get("steps")
    return None if not steps else 1e3 * run.counters["dispatch_s"] / steps
