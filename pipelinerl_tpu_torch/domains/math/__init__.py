"""Math domain: \\boxed answers graded in process, the reward table and
length shaping, and the hermetic synthetic sets. The JAX package's exports
less its verifier server (``MathEnvironment``, ``verify_answer_rpc``), which
waits for ROADMAP Queue 1 item 5."""

from .load_datasets import load_datasets, load_problems  # noqa: F401
from .rollouts import RewardTable, generate_math_rollout, get_reward  # noqa: F401
from .verifier import grade_answer  # noqa: F401
