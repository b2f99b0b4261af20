"""Instruction-following domain (IFEval-style verifiable instructions): the
JAX package's checkers, synthetic set and partial-credit rollout."""

from .checkers import CHECKERS, check_instruction  # noqa: F401
from .dataset import load_datasets, load_problems  # noqa: F401
from .rollouts import generate_ifeval_rollout  # noqa: F401
