"""The benchmark's own CPU tests: run from the repository's root with
``python -m pytest bench_torch/tests -q`` (the harness and the reference
are imported from ``bench_torch``)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
