"""Coding domain: code-generation tasks graded by running their tests on a
SandboxFusion service, or graded unverifiable where none is configured."""

from .dataset import load_datasets, load_problems  # noqa: F401
from .rollouts import CodingMetrics, generate_coding_rollout  # noqa: F401
from .verifier import evaluate_coding_prediction, extract_code, outputs_match  # noqa: F401
