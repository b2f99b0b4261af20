"""Logic-puzzle domain: synthetic puzzle sets and their verifiers, graded in
process. The JAX package's exports; its verifier server waits for ROADMAP
Queue 1 item 5."""

from .dataset import load_problems  # noqa: F401
from .rollouts import generate_logic_rollout  # noqa: F401
from .verifiers import VERIFIERS, verify_answer  # noqa: F401
