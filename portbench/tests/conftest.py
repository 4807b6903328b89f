"""The benchmark's own tests (run with ``python -m pytest portbench/tests``
from the repository's root); they import the harness from the checkout."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
