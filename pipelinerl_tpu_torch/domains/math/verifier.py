"""Math answer grading: extraction, normalization, equivalence.

A copy of the JAX package's ``domains/math/verifier.py`` (stdlib only):
the common competition-math formats (\\boxed{...}, fractions, decimals,
percentages, comma-separated thousands, simple LaTeX wrappers, tuples), and
the countdown task (an expression over exactly the given numbers that hits
the target). Expressions are evaluated by walking their AST, never by
``eval``.
"""

from __future__ import annotations

import ast
import math
import operator
import re
from fractions import Fraction

# answer_status values
CORRECT = "correct"
WRONG = "wrong"
NO_ANSWER = "no_answer"
UNPARSABLE = "unparsable"


def extract_boxed(text: str) -> str | None:
    """Last \\boxed{...} contents (brace-balanced)."""
    idx = text.rfind("\\boxed")
    if idx == -1:
        return None
    i = idx + len("\\boxed")
    while i < len(text) and text[i] in " \t":
        i += 1
    if i >= len(text):
        return None
    if text[i] != "{":
        # \boxed 5 form
        m = re.match(r"[^\s$\\]+", text[i:])
        return m.group(0) if m else None
    depth = 0
    start = i + 1
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[start:j]
    return None


_ANSWER_TAG_RE = re.compile(r"<answer>(.*?)</answer>", re.S)


def extract_answer(text: str) -> str | None:
    """Extract the final answer from a completion: \\boxed first, then
    <answer> tags, then a final 'answer is' clause."""
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed
    m = _ANSWER_TAG_RE.findall(text)
    if m:
        return m[-1].strip()
    m2 = re.findall(
        r"(?:final answer|answer)\s*(?:is|:)\s*([^\n.,;]+)", text, re.IGNORECASE
    )
    if m2:
        return m2[-1].strip()
    return None


_TEXT_CMDS = re.compile(r"\\(?:text|mathrm|mbox|textbf|mathbf)\s*\{([^{}]*)\}")


def normalize_answer(ans: str) -> str:
    s = ans.strip()
    s = _TEXT_CMDS.sub(r"\1", s)
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\!", "").replace("\\,", "").replace("\\;", "").replace("\\ ", " ")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\%", "%")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\cdot", "*").replace("\\times", "*")
    s = re.sub(r"\\d?frac\s*\{([^{}]*)\}\s*\{([^{}]*)\}", r"(\1)/(\2)", s)
    s = re.sub(r"\\frac\s*(\d)\s*(\d)", r"\1/\2", s)
    s = re.sub(r"\\sqrt\s*\{([^{}]*)\}", r"sqrt(\1)", s)
    s = s.replace("\\pi", "pi")
    s = re.sub(r"\\+", "", s)  # leftover backslashes
    s = s.replace("{", "(").replace("}", ")")
    s = s.replace(" ", "")
    # thousands separators: 1,234,567 (but not tuples like (1,2))
    if re.fullmatch(r"-?\d{1,3}(,\d{3})+(\.\d+)?", s):
        s = s.replace(",", "")
    s = s.rstrip(".")
    return s.lower()


_SAFE_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.USub: operator.neg,
    ast.UAdd: operator.pos,
}

_SAFE_NAMES = {"pi": math.pi, "e": math.e}
_SAFE_FUNCS = {"sqrt": math.sqrt, "abs": abs}


def _safe_eval(expr: str) -> float | None:
    """Numerically evaluate a simple arithmetic expression; None on failure."""
    try:
        tree = ast.parse(expr, mode="eval")
    except (SyntaxError, ValueError, MemoryError, RecursionError):
        return None

    def ev(node) -> float:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.BinOp) and type(node.op) in _SAFE_OPS:
            return _SAFE_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _SAFE_OPS:
            return _SAFE_OPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Name) and node.id in _SAFE_NAMES:
            return _SAFE_NAMES[node.id]
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in _SAFE_FUNCS
            and len(node.args) == 1
        ):
            return _SAFE_FUNCS[node.func.id](ev(node.args[0]))
        raise ValueError("unsafe")

    try:
        val = ev(tree)
        if isinstance(val, complex) or val != val:
            return None
        return float(val)
    except (ValueError, TypeError, ZeroDivisionError, OverflowError):
        return None


def _to_number(s: str) -> float | None:
    s = s.strip()
    pct = s.endswith("%")
    if pct:
        s = s[:-1]
    try:
        val = float(Fraction(s))
    except (ValueError, ZeroDivisionError):
        val = _safe_eval(s)
        if val is None:
            return None
    return val / 100.0 if pct else val


def answers_equal(pred: str, gold: str, rel_tol: float = 1e-6) -> bool:
    p, g = normalize_answer(pred), normalize_answer(gold)
    if p == g:
        return True
    pn, gn = _to_number(p), _to_number(g)
    if pn is not None and gn is not None:
        if math.isclose(pn, gn, rel_tol=rel_tol, abs_tol=1e-9):
            return True
        # percentage-form leniency: "50" vs "50%" vs "0.5"
        if math.isclose(pn, gn * 100, rel_tol=rel_tol) or math.isclose(
            pn * 100, gn, rel_tol=rel_tol
        ):
            return True
        return False
    # tuple / list answers: compare element-wise
    if ("," in p) and ("," in g):
        ps = [x for x in re.split(r"[(),]", p) if x]
        gs = [x for x in re.split(r"[(),]", g) if x]
        if len(ps) == len(gs):
            return all(answers_equal(a, b, rel_tol) for a, b in zip(ps, gs))
    return False


def grade_answer(prediction: str, gold: str, strict: bool = True) -> str:
    """→ answer_status ∈ {correct, wrong, no_answer, unparsable}."""
    if not prediction or not prediction.strip():
        return NO_ANSWER
    extracted = extract_answer(prediction)
    if extracted is None:
        return NO_ANSWER
    gold_extracted = extract_boxed(gold)
    gold_answer = gold_extracted if gold_extracted is not None else gold
    try:
        return CORRECT if answers_equal(extracted, gold_answer) else WRONG
    except (RecursionError, MemoryError):
        return UNPARSABLE


# ---------------------------------------------------------------------------
# countdown
# ---------------------------------------------------------------------------


def verify_countdown(prediction: str, numbers: list[int], target: int) -> str:
    """The countdown game: an arithmetic expression over exactly the given
    numbers (each used once) that evaluates to target."""
    expr = extract_answer(prediction)
    if expr is None:
        return NO_ANSWER
    expr = expr.replace("\\times", "*").replace("\\cdot", "*").replace(" ", "")
    if not re.fullmatch(r"[\d+\-*/()  .]+", expr):
        return UNPARSABLE
    used = [int(x) for x in re.findall(r"\d+", expr)]
    if sorted(used) != sorted(numbers):
        return WRONG
    val = _safe_eval(expr)
    if val is None:
        return UNPARSABLE
    return CORRECT if abs(val - target) < 1e-9 else WRONG
