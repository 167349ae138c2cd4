"""Share of the traced window (from the first traced ``generate`` call's
start to the last one's end) in which no operation runs on the card:
1 - union of the device intervals in the trace / window."""


def read(obs):
    if not obs.get("device"):
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["trace_window_s"])
