"""skbench's own tests, on the CPU (``python -m pytest skbench/tests`` from
the root of the repository; ``pytest tests/`` does not collect them).  A
test that needs the card carries the ``cuda`` marker and skips without
one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
