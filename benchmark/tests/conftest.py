"""The benchmark's own tests (CPU, tiny grids): python -m pytest
benchmark/tests -n 0. Tests marked `cuda` run a cell on the card and skip
where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny grids for the CPU: each configuration at a size a test can hold
TINY = {"aqua_f19": {"im": 24, "jm": 16, "km": 6},
        "hs_f05": {"im": 24, "jm": 16, "km": 4}}
