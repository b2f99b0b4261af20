"""MiniWoB web-agent domain on the simulated ``simweb.*`` tasks, run in
process or on a pool of web-environment servers
(``environment_server.WebEnvironmentServer``) with health checks and
failover."""

from .load_tasks import load_tasks  # noqa: F401
from .rollouts import generate_miniwob_rollout  # noqa: F401
