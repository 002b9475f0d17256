"""What a candidate set's first call costs beyond its later ones: for each
set called at least twice in the window, the first call's milliseconds
less the mean of the later calls', averaged over those sets (calls are
timed to their read-back, so they are synchronised)."""


def read(trace, metric, cell):
    extra = [1e3 * (s[0] - sum(s[1:]) / (len(s) - 1))
             for s in trace.readings.get("set_call_s", []) if len(s) > 1]
    if not extra:
        return None
    return sum(extra) / len(extra)
