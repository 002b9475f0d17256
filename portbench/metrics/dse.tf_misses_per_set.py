"""Transfer-plane builds a candidate set: the rise of the port's
``propagation.tf_cache_stats()`` misses over the window, over the sets
called in it."""


def read(trace, metric, cell):
    sets = trace.readings.get("sets", 0)
    if sets <= 0:
        return None
    return trace.readings["tf_misses"] / sets
