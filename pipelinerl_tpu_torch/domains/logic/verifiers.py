"""Self-written verifiers for logic-puzzle task families.

A copy of the JAX package's ``domains/logic/verifiers.py`` (stdlib only):
each task type maps to a verifier with
``extract_answer(prediction) -> str | None`` and
``verify(game_data, prediction) -> bool``; ``verify_answer`` wraps the
registry and returns an answer status in
{"correct", "wrong", "no_answer", "unparsable"}. The checkers are
deterministic over a ``game_data`` dict produced by the generators in
``dataset.py``; expressions are evaluated by AST walkers, never ``eval``.
"""

from __future__ import annotations

import ast
import logging
import re
from typing import Any

logger = logging.getLogger(__name__)

CORRECT = "correct"
WRONG = "wrong"
NO_ANSWER = "no_answer"
UNPARSABLE = "unparsable"

_ANSWER_TAG_RE = re.compile(r"<answer>\s*(.*?)\s*</answer>", re.DOTALL | re.IGNORECASE)
_BOXED_RE = re.compile(r"\\boxed\{([^{}]*)\}")


def extract_answer(prediction: str) -> str | None:
    """Pull the final answer out of a model response: last <answer> tag,
    else last \\boxed{}, else the text after a final 'Answer:' marker."""
    if not prediction or not prediction.strip():
        return None
    tags = _ANSWER_TAG_RE.findall(prediction)
    if tags:
        return tags[-1].strip()
    boxed = _BOXED_RE.findall(prediction)
    if boxed:
        return boxed[-1].strip()
    m = re.search(r"(?:final\s+)?answer\s*[:=]\s*(.+?)\s*$",
                  prediction.strip(), re.IGNORECASE | re.MULTILINE)
    if m:
        return m.group(1).strip()
    return None


def _norm(text: str) -> str:
    return re.sub(r"\s+", " ", text.strip().lower()).strip(" .\"'`")


class Verifier:
    """Base: compare the extracted answer against game_data['answer']."""

    def extract_answer(self, prediction: str) -> str | None:
        return extract_answer(prediction)

    def verify(self, game_data: dict, prediction: str) -> bool:
        ans = self.extract_answer(prediction)
        if ans is None:
            return False
        return self.check(game_data, ans)

    def check(self, game_data: dict, answer: str) -> bool:
        return _norm(answer) == _norm(str(game_data.get("answer", "")))


class BooleanExpressionVerifier(Verifier):
    """Answer is True/False; game_data carries the expression itself so the
    verifier re-evaluates rather than trusting a stored label."""

    def check(self, game_data: dict, answer: str) -> bool:
        expr = game_data.get("expression")
        token = _norm(answer)
        if token not in ("true", "false"):
            return False
        if expr is None:
            return token == _norm(str(game_data.get("answer", "")))
        truth = bool(_safe_bool_eval(expr))
        return (token == "true") == truth


def _safe_bool_eval(expr: str) -> bool:
    """Evaluate a boolean expression of and/or/not/parentheses/True/False
    via the AST (no eval of arbitrary code)."""
    node = ast.parse(expr, mode="eval").body

    def rec(n: ast.AST) -> bool:
        if isinstance(n, ast.BoolOp):
            vals = [rec(v) for v in n.values]
            return all(vals) if isinstance(n.op, ast.And) else any(vals)
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            return not rec(n.operand)
        if isinstance(n, ast.Constant) and isinstance(n.value, bool):
            return n.value
        raise ValueError(f"disallowed node {type(n).__name__}")

    return rec(node)


class MultistepArithmeticVerifier(Verifier):
    """Integer arithmetic (+ - * parentheses); re-evaluates the expression."""

    def check(self, game_data: dict, answer: str) -> bool:
        m = re.search(r"-?\d+", answer.replace(",", ""))
        if not m:
            return False
        got = int(m.group(0))
        expr = game_data.get("expression")
        if expr is None:
            return got == int(game_data.get("answer"))
        return got == _safe_int_eval(expr)


def _safe_int_eval(expr: str) -> int:
    node = ast.parse(expr, mode="eval").body

    def rec(n: ast.AST) -> int:
        if isinstance(n, ast.BinOp):
            l, r = rec(n.left), rec(n.right)
            if isinstance(n.op, ast.Add):
                return l + r
            if isinstance(n.op, ast.Sub):
                return l - r
            if isinstance(n.op, ast.Mult):
                return l * r
            raise ValueError("disallowed operator")
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -rec(n.operand)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        raise ValueError(f"disallowed node {type(n).__name__}")

    return rec(node)


class DyckLanguageVerifier(Verifier):
    """game_data['prefix'] is an unbalanced bracket string; the answer must be
    the exact sequence of closing brackets that balances it."""

    _CLOSE = {"(": ")", "[": "]", "{": "}", "<": ">"}

    def check(self, game_data: dict, answer: str) -> bool:
        prefix = game_data.get("prefix", "")
        stack: list[str] = []
        for ch in prefix:
            if ch in self._CLOSE:
                stack.append(self._CLOSE[ch])
            elif ch in self._CLOSE.values():
                if not stack or stack.pop() != ch:
                    return False  # malformed prefix: nothing can balance it
        expected = "".join(reversed(stack))
        got = re.sub(r"[^)\]}>]", "", answer)
        return got == expected


class WordSortingVerifier(Verifier):
    """Answer must list game_data['words'] in lexicographic order."""

    def check(self, game_data: dict, answer: str) -> bool:
        words = [w.lower() for w in game_data.get("words", [])]
        got = [w for w in re.split(r"[,\s]+", answer.lower()) if w]
        return got == sorted(words)


class WebOfLiesVerifier(Verifier):
    """Chain of 'X says Y lies/tells the truth' statements; answer yes/no for
    whether the last person tells the truth. game_data: statements =
    list of bools (True = 'tells the truth' edge), first_truth = bool."""

    def check(self, game_data: dict, answer: str) -> bool:
        token = _norm(answer)
        if token not in ("yes", "no", "true", "false"):
            return False
        truth = bool(game_data.get("first_truth", True))
        for says_truth in game_data.get("statements", []):
            truth = truth if says_truth else not truth
        got = token in ("yes", "true")
        return got == truth


class NavigationVerifier(Verifier):
    """Sequence of moves on a grid (steps with turns); answer yes/no for
    'do you return to the start?'. game_data: moves = list of (dx, dy)."""

    def check(self, game_data: dict, answer: str) -> bool:
        token = _norm(answer)
        if token not in ("yes", "no"):
            return False
        x = sum(dx for dx, _ in game_data.get("moves", []))
        y = sum(dy for _, dy in game_data.get("moves", []))
        return (token == "yes") == (x == 0 and y == 0)


class ZebraPuzzleVerifier(Verifier):
    """Mini zebra/Einstein puzzle. game_data['solution'] maps house index →
    {attr: value}; game_data['query'] is (attribute, value, target_attribute);
    the answer must equal solution[house with attr=value][target_attribute]."""

    def check(self, game_data: dict, answer: str) -> bool:
        solution = game_data.get("solution", {})
        attr, value, target = game_data.get("query", (None, None, None))
        for house in solution.values():
            if _norm(str(house.get(attr, ""))) == _norm(str(value)):
                return _norm(answer) == _norm(str(house.get(target, "")))
        return False


class SudokuLiteVerifier(Verifier):
    """4x4 sudoku: answer must be 16 digits (rows concatenated or spaced)
    that complete game_data['puzzle'] (0 = blank) into a valid grid."""

    def check(self, game_data: dict, answer: str) -> bool:
        digits = re.findall(r"[1-4]", answer)
        if len(digits) != 16:
            return False
        grid = [[int(digits[r * 4 + c]) for c in range(4)] for r in range(4)]
        puzzle = game_data.get("puzzle", [])
        for r in range(4):
            for c in range(4):
                if puzzle[r][c] and puzzle[r][c] != grid[r][c]:
                    return False
        target = {1, 2, 3, 4}
        for i in range(4):
            if set(grid[i]) != target or {grid[r][i] for r in range(4)} != target:
                return False
        for br in (0, 2):
            for bc in (0, 2):
                box = {grid[br + r][bc + c] for r in range(2) for c in range(2)}
                if box != target:
                    return False
        return True


class CryptarithmVerifier(Verifier):
    """game_data: words (addends), result, answer may fix a mapping. The
    model answers the digit assignment as 'A=1, B=2, ...'; verify the sum."""

    def check(self, game_data: dict, answer: str) -> bool:
        mapping: dict[str, int] = {}
        for letter, digit in re.findall(r"([A-Za-z])\s*[:=]\s*(\d)", answer):
            mapping[letter.upper()] = int(digit)
        words = [w.upper() for w in game_data.get("words", [])]
        result = str(game_data.get("result", "")).upper()
        letters = set("".join(words) + result)
        if not letters.issubset(mapping.keys()):
            return False
        if len({mapping[c] for c in letters}) != len(letters):
            return False  # digits must be distinct
        for w in words + [result]:
            if len(w) > 1 and mapping[w[0]] == 0:
                return False

        def value(word: str) -> int:
            return int("".join(str(mapping[c]) for c in word))

        return sum(value(w) for w in words) == value(result)


class DateUnderstandingVerifier(Verifier):
    """Answer is a date; accepted in YYYY-MM-DD or MM/DD/YYYY forms."""

    def check(self, game_data: dict, answer: str) -> bool:
        want = str(game_data.get("answer", ""))  # canonical YYYY-MM-DD
        m = re.search(r"(\d{4})-(\d{2})-(\d{2})", answer)
        if m:
            return m.group(0) == want
        m = re.search(r"(\d{1,2})/(\d{1,2})/(\d{4})", answer)
        if m:
            mm, dd, yy = int(m.group(1)), int(m.group(2)), m.group(3)
            return f"{yy}-{mm:02d}-{dd:02d}" == want
        return False


VERIFIERS: dict[str, Verifier] = {
    "boolean_expressions": BooleanExpressionVerifier(),
    "multistep_arithmetic": MultistepArithmeticVerifier(),
    "dyck_languages": DyckLanguageVerifier(),
    "word_sorting": WordSortingVerifier(),
    "web_of_lies": WebOfLiesVerifier(),
    "navigation": NavigationVerifier(),
    "zebra_puzzle": ZebraPuzzleVerifier(),
    "sudoku": SudokuLiteVerifier(),
    "cryptarithm": CryptarithmVerifier(),
    "date_understanding": DateUnderstandingVerifier(),
}


def verify_answer(prediction: str, reward_context: dict[str, Any]) -> str:
    """Registry dispatch: returns one of
    correct / wrong / no_answer / unparsable."""
    task = reward_context.get("task")
    game_data = reward_context.get("game_data")
    if not task or game_data is None:
        return UNPARSABLE
    verifier = VERIFIERS.get(task)
    if verifier is None:
        logger.warning("no verifier for task type %r", task)
        return UNPARSABLE
    if not prediction or not prediction.strip():
        return NO_ANSWER
    if verifier.extract_answer(prediction) is None:
        return NO_ANSWER
    try:
        return CORRECT if verifier.verify(game_data, prediction) else WRONG
    except Exception:
        logger.warning("verifier crashed for task %r", task, exc_info=True)
        return UNPARSABLE
