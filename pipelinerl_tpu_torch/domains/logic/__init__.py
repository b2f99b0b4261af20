"""Logic-puzzle domain: synthetic puzzle sets and their verifiers, graded in
process or by the verifier server (``verifier_api.LogicEnvironment``). The
JAX package's exports."""

from .dataset import load_problems  # noqa: F401
from .rollouts import generate_logic_rollout  # noqa: F401
from .verifiers import VERIFIERS, verify_answer  # noqa: F401
