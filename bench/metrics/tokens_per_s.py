"""Prompt tokens as sent (not padding) plus generated tokens, over every
request completed in the window, per second of the window (from its
start to the end of its last wave)."""


def read(obs):
    return sum(p + n for p, n, _ in obs["requests"]) / obs["window_s"]
