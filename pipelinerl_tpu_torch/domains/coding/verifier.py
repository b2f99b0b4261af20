"""Coding verification: extract code, run the problem's tests, grade.

Port of the JAX package's ``domains/coding/verifier.py``: markdown code
extraction, stdin/stdout and functional (``fn_name``) tests, tolerant output
comparison (whitespace, trailing newlines, a relative decimal tolerance per
token), and the compile/runtime/timeout error taxonomy that feeds the reward
table.

Code runs on a SandboxFusion-compatible service through the executor the
rollout passes in. Without one the rollout's executor refuses to run code
and every test reads as unverifiable: the port, like the JAX package, runs
no untrusted code locally.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from decimal import Decimal, InvalidOperation
from typing import Any

_CODE_BLOCK_RE = re.compile(r"```(?:python|py)?\s*\n(.*?)```", re.S)


def extract_code(prediction: str | None) -> str:
    """Last fenced code block, else the raw text when it looks like code."""
    if not prediction:
        return ""
    blocks = _CODE_BLOCK_RE.findall(prediction)
    if blocks:
        return blocks[-1].strip()
    text = prediction.strip()
    if any(kw in text for kw in ("def ", "import ", "print(", "class ")):
        return text
    return ""


def _normalize_output(text: str | None) -> str:
    if text is None:
        return ""
    return "\n".join(line.rstrip() for line in str(text).rstrip().splitlines())


def _to_decimals(line: str) -> list[Decimal] | None:
    try:
        return [Decimal(tok) for tok in line.split()]
    except (InvalidOperation, ValueError):
        return None


def outputs_match(actual: str | None, expected: str | None, rel_tol: float = 1e-6) -> bool:
    """Whitespace-tolerant comparison with per-line decimal tolerance
    (reference _outputs_match, verifier_api.py:173-191)."""
    a, e = _normalize_output(actual), _normalize_output(expected)
    if a == e:
        return True
    a_lines = [l.strip() for l in a.splitlines() if l.strip()]
    e_lines = [l.strip() for l in e.splitlines() if l.strip()]
    if len(a_lines) != len(e_lines):
        return False
    for la, le in zip(a_lines, e_lines):
        if la == le:
            continue
        da, de = _to_decimals(la), _to_decimals(le)
        if da is None or de is None or len(da) != len(de):
            return False
        for x, y in zip(da, de):
            if y == 0:
                if abs(x) > Decimal(str(rel_tol)):
                    return False
            elif abs(x - y) / abs(y) > Decimal(str(rel_tol)):
                return False
    return True


def build_stdin_script(user_code: str, stdin_input: str) -> str:
    """Wrap user code so stdin comes from the test input."""
    return (
        "import sys, io\n"
        f"sys.stdin = io.StringIO({stdin_input!r})\n"
        "def input(*a): return sys.stdin.readline().rstrip('\\n')\n"
        + user_code
    )


def build_functional_script(user_code: str, fn_name: str, args: list[Any]) -> str:
    args_src = ", ".join(repr(a) for a in args)
    return (
        f"{user_code}\n"
        f"import json as _json\n"
        f"_result = {fn_name}({args_src})\n"
        f"print(_json.dumps(_result))\n"
    )


@dataclass
class CodingVerification:
    answer_status: str = "wrong"  # correct | wrong | no_answer | unparsable
    passed: int = 0
    total: int = 0
    compile_error: bool = False
    runtime_error: bool = False
    timeout_error: bool = False
    empty_response: bool = False
    details: list[dict] = field(default_factory=list)

    def to_payload(self) -> dict[str, Any]:
        return {
            "answer_status": self.answer_status,
            "passed": self.passed,
            "total": self.total,
            "compile_error": self.compile_error,
            "runtime_error": self.runtime_error,
            "timeout_error": self.timeout_error,
            "empty_response": self.empty_response,
        }


def _stderr_indicates_failure(stderr: str) -> bool:
    return bool(stderr) and ("Traceback" in stderr or "Error" in stderr)


async def evaluate_coding_prediction(
    prediction: str,
    tests: dict[str, Any] | list[dict] | str,
    executor,
    max_tests: int = 16,
) -> CodingVerification:
    """Run the problem's tests against the predicted code.

    ``tests``: TACO/APPS-style {"inputs": [...], "outputs": [...]} with
    optional "fn_name" for functional mode, or a list of
    {"input", "expected_output"} dicts. ``executor(code) -> str`` runs code
    and returns combined output (sandbox client or test stub).
    """
    v = CodingVerification()
    code = extract_code(prediction)
    if not code:
        v.empty_response = True
        v.answer_status = "no_answer"
        return v

    if isinstance(tests, str):
        try:
            tests = json.loads(tests)
        except json.JSONDecodeError:
            v.answer_status = "unparsable"
            return v
    if isinstance(tests, dict):
        fn_name = tests.get("fn_name")
        inputs = list(tests.get("inputs", []))
        outputs = list(tests.get("outputs", []))
        cases = [
            {"input": i, "expected_output": o, "fn_name": fn_name}
            for i, o in zip(inputs, outputs)
        ]
    else:
        cases = list(tests)
    cases = cases[:max_tests]
    v.total = len(cases)

    for case in cases:
        fn_name = case.get("fn_name")
        expected = case.get("expected_output")
        if fn_name:
            args = case.get("input")
            if not isinstance(args, list):
                args = [args]
            script = build_functional_script(code, fn_name, args)
        else:
            stdin = case.get("input") or ""
            if isinstance(stdin, list):
                stdin = "\n".join(str(x) for x in stdin)
            script = build_stdin_script(code, str(stdin))
        out = await executor(script)
        out_str = str(out)
        if out_str.startswith("[execution timed out]") or "[execution timed out]" in out_str:
            v.timeout_error = True
            v.details.append({"status": "timeout"})
            continue
        if "[execution error" in out_str or "SyntaxError" in out_str:
            v.compile_error = True
            v.details.append({"status": "compile_error", "output": out_str[:500]})
            continue
        stdout, _, stderr = out_str.partition("[stderr]")
        if _stderr_indicates_failure(stderr):
            v.runtime_error = True
            v.details.append({"status": "runtime_error", "output": stderr[:500]})
            continue
        if fn_name:
            try:
                actual_val = json.loads(stdout.strip().splitlines()[-1]) if stdout.strip() else None
            except (json.JSONDecodeError, IndexError):
                actual_val = stdout.strip()
            expected_val = expected
            ok = actual_val == expected_val or outputs_match(
                json.dumps(actual_val), json.dumps(expected_val)
            )
        else:
            ok = outputs_match(stdout, str(expected))
        if ok:
            v.passed += 1
        v.details.append({"status": "passed" if ok else "failed"})

    if v.total == 0:
        v.answer_status = "unparsable"
    elif v.compile_error or v.timeout_error:
        v.answer_status = "unparsable"
    elif v.passed == v.total:
        v.answer_status = "correct"
    else:
        v.answer_status = "wrong"
    return v
