"""Seconds from the start of the process to the start of the window:
imports, the weights drawn on the card, the kernels' build (first run in
a checkout only), CoSA's schedules and one warm wave of the cell's
shapes."""


def read(obs):
    return obs["setup_s"]
