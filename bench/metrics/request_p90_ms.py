"""90th percentile of request latency over every request of the window:
from the start of the ``generate`` call that served it to its return
(after a synchronise, so its device work is done)."""

import numpy as np


def read(obs):
    return float(np.percentile([lat for _, _, lat in obs["requests"]], 90)) * 1e3
