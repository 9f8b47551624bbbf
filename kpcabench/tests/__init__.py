"""CPU tests of the benchmark harness (``python -m pytest kpcabench/tests``
from the repository root); the one marked ``gpu`` skips without a card."""
