"""Paths for the benchmark's own tests, imported first by each of them:
``python -m pytest benchmark/tests -q`` from the repository's root.  The
benchmark's folder and the repository's root go on ``sys.path``, as
``benchmark/run.py`` has them."""

import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]
torch.set_num_threads(2)
