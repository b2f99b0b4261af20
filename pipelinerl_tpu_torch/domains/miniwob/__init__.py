"""MiniWoB web-agent domain on the simulated ``simweb.*`` tasks, run in
process; the environment-server pool (BrowserGym or simulated tasks behind
HTTP) waits for ROADMAP Queue 1 item 5."""

from .load_tasks import load_tasks  # noqa: F401
from .rollouts import generate_miniwob_rollout  # noqa: F401
