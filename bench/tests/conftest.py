"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
root of a checkout; ``-m cuda`` on a card.  The harness imports its
modules by their names in ``bench/`` and the port from ``src/``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "bench", ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
