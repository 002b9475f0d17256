"""Host milliseconds a training step, the mean over the window's chunk
calls of the time a call took to return over its steps.  Nothing is
synchronised around the call, so this is what the host spends handing
the step to the device, and it reads high when the launch queue is full
or a copy waits for the device."""


def read(trace, metric, cell):
    per_step = trace.readings.get("dispatch_s_per_step", [])
    if not per_step:
        return None
    return 1e3 * sum(per_step) / len(per_step)
