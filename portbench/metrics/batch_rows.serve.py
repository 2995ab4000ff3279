"""Requests a forward in the window, from ``MicroBatcher.stats()``'s
differences."""


def read(run):
    f = run.counters.get("forwards")
    return None if not f else run.counters["batched_requests"] / f
