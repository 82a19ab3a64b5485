"""Test set-up for the harness's own tests: the harness and the port
import from the checkout (``portbench`` and ``src/``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
