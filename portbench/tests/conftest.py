"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q -p no:cacheprovider``
from the root of the checkout. Tests marked ``cuda`` run on a card only."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
