"""The benchmark's tests run from the repository root or from anywhere: the
root goes on the path, and no test here imports JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
