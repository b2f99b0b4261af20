"""ChartQA answer evaluation: relaxed correctness per the ChartQA paper
(arXiv:2203.10244 §5.1: a numeric answer within 5% relative error is
correct; anything else needs a case-insensitive exact match).

A copy of the JAX package's ``domains/chartqa/evaluation.py``.
"""

from __future__ import annotations

import re


def _parse_number(text: str) -> float | None:
    text = text.strip().replace(",", "")
    try:
        if text.endswith("%"):
            return float(text[:-1]) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_correctness(target: str, prediction: str, max_relative_change: float = 0.05) -> bool:
    p, t = _parse_number(prediction), _parse_number(target)
    if p is not None and t is not None and t != 0:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.strip().lower() == target.strip().lower()


_BOXED_RE = re.compile(r"\\boxed\{([^{}]*)\}")
_ANSWER_RE = re.compile(r"(?:final answer|answer)\s*(?:is|:)\s*(.+?)(?:\.|$)", re.IGNORECASE)


def extract_answer(text: str) -> str | None:
    """The last \\boxed{...} if present, else an 'answer is/answer:' tail,
    else the stripped text itself when it is short (a bare answer)."""
    boxed = _BOXED_RE.findall(text)
    if boxed:
        return boxed[-1].strip()
    m = None
    for m in _ANSWER_RE.finditer(text):
        pass
    if m:
        return m.group(1).strip()
    stripped = text.strip()
    if stripped and len(stripped) <= 40 and "\n" not in stripped:
        return stripped
    return None


def evaluate_answer(predicted_text: str, ground_truth: str) -> str:
    """-> "correct" | "wrong" | "no_answer" | "unparsable"."""
    try:
        answer = extract_answer(predicted_text or "")
        if answer is None:
            return "no_answer"
        return "correct" if relaxed_correctness(ground_truth, answer) else "wrong"
    except Exception:
        return "unparsable"
