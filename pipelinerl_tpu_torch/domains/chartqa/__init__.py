from .chartqa import generate_chartqa_rollout, load_datasets  # noqa: F401
