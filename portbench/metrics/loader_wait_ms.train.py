"""Host time a step spends between the trainer's previous step call and
the next: the loader's ``next()`` (and the loop's bookkeeping), the
trainer's ``loader_wait_s`` taken at the same boundaries by the benchmark."""


def read(run):
    steps = run.counters.get("steps")
    return None if not steps else 1e3 * run.counters["loader_wait_s"] / steps
