"""Math domain: \\boxed answers graded in process or by the verifier server
(``MathEnvironment``), the reward table and length shaping, and the
hermetic synthetic sets. The JAX package's exports."""

from .load_datasets import load_datasets, load_problems  # noqa: F401
from .rollouts import RewardTable, generate_math_rollout, get_reward  # noqa: F401
from .verifier import grade_answer  # noqa: F401
from .verifier_api import MathEnvironment, verify_answer_rpc  # noqa: F401
