"""AST-based function-call verification (BFCL v3 style).

Grades a model's emitted call(s) against gold call specifications:
- function name must match (dots/underscores normalized),
- required args must be present and equal (numeric tolerance, case-tolerant
  strings, unordered lists where the gold offers alternatives),
- gold values given as a list mean "any of these is acceptable" (the BFCL
  convention), empty-list gold means the arg is optional,
- extra hallucinated args fail the call; partial credit = fraction of
  matching calls.

A copy of the JAX package's ``domains/fn_calling/verifier.py``.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Any

from ...inference.tool_parser import parse_tool_calls


def _norm_name(name: str) -> str:
    return name.replace(".", "_").lower()


def parse_call(text: str) -> list[dict]:
    """Extract calls from model output: OpenAI tool_call blocks first, then
    python-style ``func(a=1, b="x")`` source."""
    calls, _ = parse_tool_calls(text)
    out = []
    for c in calls:
        try:
            args = json.loads(c.function.arguments)
        except json.JSONDecodeError:
            args = {}
        out.append({"name": c.function.name, "arguments": args if isinstance(args, dict) else {}})
    if out:
        return out
    # python-call style: [func(a=1), other(b='x')] or bare calls
    candidates = re.findall(r"\b([A-Za-z_][\w.]*)\s*\(([^()]*)\)", text)
    for name, argsrc in candidates:
        if name in ("print", "json", "dict", "list", "str", "int", "float"):
            continue
        try:
            call = ast.parse(f"f({argsrc})", mode="eval").body
            args = {
                kw.arg: ast.literal_eval(kw.value)
                for kw in call.keywords
                if kw.arg is not None
            }
        except (SyntaxError, ValueError):
            continue
        out.append({"name": name, "arguments": args})
    return out


def _values_equal(pred: Any, gold: Any) -> bool:
    if isinstance(gold, list) and not isinstance(pred, list):
        # gold list = acceptable alternatives
        return any(_values_equal(pred, g) for g in gold)
    if isinstance(pred, (int, float)) and isinstance(gold, (int, float)):
        return abs(float(pred) - float(gold)) < 1e-6
    if isinstance(pred, str) and isinstance(gold, str):
        return pred.strip().lower() == gold.strip().lower()
    if isinstance(pred, list) and isinstance(gold, list):
        if len(pred) != len(gold):
            return False
        return all(_values_equal(p, g) for p, g in zip(pred, gold))
    if isinstance(pred, dict) and isinstance(gold, dict):
        return set(pred) == set(gold) and all(
            _values_equal(pred[k], gold[k]) for k in gold
        )
    return pred == gold


def _call_matches(pred: dict, gold: dict) -> bool:
    gold_name, gold_args = next(iter(gold.items())) if "name" not in gold else (
        gold["name"],
        gold.get("arguments", {}),
    )
    if _norm_name(pred["name"]) != _norm_name(str(gold_name)):
        return False
    pred_args = pred.get("arguments", {})
    for arg, gold_val in gold_args.items():
        optional = isinstance(gold_val, list) and len(gold_val) == 0
        if arg not in pred_args:
            if optional:
                continue
            return False
        if optional:
            continue
        if not _values_equal(pred_args[arg], gold_val):
            return False
    # hallucinated args not in the schema's gold set fail the call
    extra = set(pred_args) - set(gold_args)
    if extra:
        return False
    return True


def ast_match_score(prediction: str, gold_calls: list[dict] | dict) -> float:
    """→ fraction of gold calls matched in order-insensitive fashion
    (1.0 = perfect)."""
    if isinstance(gold_calls, dict):
        gold_calls = [gold_calls]
    if not gold_calls:
        return 0.0
    pred_calls = parse_call(prediction)
    if not pred_calls:
        return 0.0
    remaining = list(pred_calls)
    matched = 0
    for gold in gold_calls:
        hit = next((p for p in remaining if _call_matches(p, gold)), None)
        if hit is not None:
            matched += 1
            remaining.remove(hit)
    # hallucinated extra calls dilute the score
    denom = max(len(gold_calls), len(pred_calls))
    return matched / denom
