"""Function-calling domain (BFCL-style AST verification): the JAX package's
verifier, synthetic set and rollout."""

from .dataset import load_datasets, load_problems  # noqa: F401
from .rollouts import generate_fn_calling_rollout  # noqa: F401
from .verifier import ast_match_score, parse_call  # noqa: F401
