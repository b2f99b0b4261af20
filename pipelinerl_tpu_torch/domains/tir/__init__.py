"""Tool-integrated reasoning (TIR): multi-turn ``run_python_code`` calls and
a ``MathAnswer`` tool, graded through the math reward table plus shaping.
Code runs on a SandboxFusion service when ``sandbox_url`` is set, else the
hermetic expression evaluator answers."""

from .rollouts import generate_tir_rollout  # noqa: F401
from .tool_parser import ToolCall, parse_tool_calls  # noqa: F401
