"""Requests a served batch carried in the window, from the port's own
``InferenceEngine.stats``."""


def read(trace, metric, cell):
    batches = trace.readings.get("batches", 0)
    if batches <= 0:
        return None
    return trace.readings["requests"] / batches
