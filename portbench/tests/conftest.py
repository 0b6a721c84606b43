"""Settings of the benchmark's own tests: the card marker, and the
benchmark's folder and the repository's root on the import path.  Run them
with `python -m pytest -q portbench/tests` (the CPU cases) and, on the
card, `python -m pytest -q -m cuda portbench/tests`."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("UNIMOE_AUDIO_QUIET", "1")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
