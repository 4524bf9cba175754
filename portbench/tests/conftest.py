"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root. Tests marked ``cuda`` need a card and skip without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
