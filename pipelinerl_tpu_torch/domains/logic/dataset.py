"""Logic-domain problem sets: the synthetic generators of the JAX
package's ``domains/logic/dataset.py``, item for item.

Problems carry {task, reward_context{task, game_data}, dataset, domain};
every generated problem is self-consistent (the generator computes the
ground truth the same way the verifier re-checks it). The INTELLECT-3 hub
set (``intellect3[@subset]``) needs dataset files that are not in the
repository, so asking for it raises.
"""

from __future__ import annotations

import random
from typing import Any

DOMAIN = "logic"

_PROMPT_SUFFIX = " Output the final answer as <answer>...</answer>."


def _gen_boolean(rng: random.Random) -> dict:
    def expr(depth: int) -> str:
        if depth == 0:
            return rng.choice(["True", "False"])
        op = rng.choice(["and", "or", "not"])
        if op == "not":
            return f"not ({expr(depth - 1)})"
        return f"({expr(depth - 1)}) {op} ({expr(depth - 1)})"

    e = expr(rng.randint(2, 4))
    return {
        "task": f"Evaluate: {e}. Answer True or False.{_PROMPT_SUFFIX}",
        "reward_context": {"task": "boolean_expressions", "game_data": {"expression": e}},
    }


def _gen_arithmetic(rng: random.Random) -> dict:
    def expr(depth: int) -> str:
        if depth == 0:
            return str(rng.randint(-9, 9))
        op = rng.choice(["+", "-", "*"])
        return f"({expr(depth - 1)} {op} {expr(depth - 1)})"

    e = expr(rng.randint(2, 3))
    return {
        "task": f"Compute: {e} = ?{_PROMPT_SUFFIX}",
        "reward_context": {"task": "multistep_arithmetic", "game_data": {"expression": e}},
    }


def _gen_dyck(rng: random.Random) -> dict:
    pairs = [("(", ")"), ("[", "]"), ("{", "}"), ("<", ">")]
    seq: list[str] = []
    stack: list[str] = []
    for _ in range(rng.randint(6, 14)):
        if len(stack) > 2 and rng.random() < 0.4:
            seq.append(stack.pop())
        else:
            o, c = rng.choice(pairs)
            seq.append(o)
            stack.append(c)
    prefix = "".join(seq)  # ≥2 brackets always remain open
    return {
        "task": (
            "Complete the rest of the sequence so all brackets close properly: "
            f"{prefix}{_PROMPT_SUFFIX}"
        ),
        "reward_context": {"task": "dyck_languages", "game_data": {"prefix": prefix}},
    }


_WORDBANK = (
    "apple banana cherry date elderberry fig grape honeydew kiwi lemon mango "
    "nectarine orange papaya quince raspberry strawberry tangerine watermelon "
    "zucchini almond basil cedar dahlia ebony fennel ginger hazel iris jasmine"
).split()


def _gen_word_sorting(rng: random.Random) -> dict:
    words = rng.sample(_WORDBANK, rng.randint(5, 9))
    return {
        "task": (
            "Sort these words alphabetically, comma-separated: "
            f"{', '.join(words)}.{_PROMPT_SUFFIX}"
        ),
        "reward_context": {"task": "word_sorting", "game_data": {"words": words}},
    }


_NAMES = ["Ava", "Ben", "Cara", "Dan", "Elle", "Finn", "Gia", "Hugo"]


def _gen_web_of_lies(rng: random.Random) -> dict:
    n = rng.randint(3, 6)
    names = rng.sample(_NAMES, n)
    first_truth = rng.random() < 0.5
    lines = [f"{names[0]} {'tells the truth' if first_truth else 'lies'}."]
    statements = []
    for i in range(1, n):
        says_truth = rng.random() < 0.5
        statements.append(says_truth)
        lines.append(
            f"{names[i]} says {names[i - 1]} "
            f"{'tells the truth' if says_truth else 'lies'}."
        )
    lines.append(f"Does {names[-1]} tell the truth? Answer yes or no.")
    return {
        "task": " ".join(lines) + _PROMPT_SUFFIX,
        "reward_context": {
            "task": "web_of_lies",
            "game_data": {"first_truth": first_truth, "statements": statements},
        },
    }


def _gen_navigation(rng: random.Random) -> dict:
    n = rng.randint(3, 6)
    moves = []
    steps = []
    dirs = {"north": (0, 1), "south": (0, -1), "east": (1, 0), "west": (-1, 0)}
    for _ in range(n):
        name, (dx, dy) = rng.choice(list(dirs.items()))
        k = rng.randint(1, 5)
        moves.append((dx * k, dy * k))
        steps.append(f"walk {k} step{'s' if k > 1 else ''} {name}")
    # half the time, force a return to start by appending the inverse walk
    if rng.random() < 0.5:
        x = sum(dx for dx, _ in moves)
        y = sum(dy for _, dy in moves)
        for delta, names in ((x, ("west", "east")), (y, ("south", "north"))):
            if delta:
                name = names[0] if delta > 0 else names[1]
                moves.append((-delta, 0) if names[0] in ("west",) else (0, -delta))
                steps.append(f"walk {abs(delta)} steps {name}")
    return {
        "task": (
            "You start at the origin. "
            + ", then ".join(steps)
            + ". Do you return to the starting point? Answer yes or no."
            + _PROMPT_SUFFIX
        ),
        "reward_context": {"task": "navigation", "game_data": {"moves": moves}},
    }


_COLORS = ["red", "green", "blue", "yellow"]
_PETS = ["cat", "dog", "fish", "bird"]
_DRINKS = ["tea", "coffee", "milk", "juice"]


def _gen_zebra(rng: random.Random) -> dict:
    n = 3
    people = rng.sample(_NAMES, n)
    colors = rng.sample(_COLORS, n)
    pets = rng.sample(_PETS, n)
    solution = {
        str(i): {"person": people[i], "color": colors[i], "pet": pets[i]}
        for i in range(n)
    }
    clues = []
    for i in range(n):
        clues.append(f"{people[i]} lives in house {i + 1}.")
        clues.append(f"The person in house {i + 1} has a {pets[i]}.")
        clues.append(f"House {i + 1} is {colors[i]}.")
    rng.shuffle(clues)
    i = rng.randrange(n)
    query = ("person", people[i], "pet")
    return {
        "task": (
            f"Three houses in a row (1..{n}). " + " ".join(clues)
            + f" What pet does {people[i]} have?" + _PROMPT_SUFFIX
        ),
        "reward_context": {
            "task": "zebra_puzzle",
            "game_data": {"solution": solution, "query": list(query)},
        },
    }


def _gen_sudoku(rng: random.Random) -> dict:
    base = [[1, 2, 3, 4], [3, 4, 1, 2], [2, 1, 4, 3], [4, 3, 2, 1]]
    perm = list(rng.sample([1, 2, 3, 4], 4))
    grid = [[perm[v - 1] for v in row] for row in base]
    # validity-preserving shuffles: permute rows within each 2-row band,
    # then optionally swap the bands
    bands = [[0, 1], [2, 3]]
    for band in bands:
        rng.shuffle(band)
    if rng.random() < 0.5:
        bands.reverse()
    grid = [grid[r] for band in bands for r in band]
    puzzle = [row[:] for row in grid]
    for _ in range(rng.randint(6, 9)):
        puzzle[rng.randrange(4)][rng.randrange(4)] = 0
    rendered = "\n".join(" ".join(str(v) if v else "_" for v in row) for row in puzzle)
    return {
        "task": (
            "Fill in this 4x4 sudoku (rows/columns/2x2 boxes each contain 1-4). "
            f"Blanks are _:\n{rendered}\nAnswer with all 16 digits row by row."
            + _PROMPT_SUFFIX
        ),
        "reward_context": {"task": "sudoku", "game_data": {"puzzle": puzzle}},
    }


def _gen_date(rng: random.Random) -> dict:
    import datetime

    start = datetime.date(2020, 1, 1) + datetime.timedelta(days=rng.randint(0, 2000))
    delta = rng.randint(-90, 90)
    answer = start + datetime.timedelta(days=delta)
    direction = "after" if delta >= 0 else "before"
    return {
        "task": (
            f"What date is {abs(delta)} days {direction} {start.isoformat()}? "
            f"Answer in YYYY-MM-DD format.{_PROMPT_SUFFIX}"
        ),
        "reward_context": {
            "task": "date_understanding",
            "game_data": {"answer": answer.isoformat()},
        },
    }


_GENERATORS = {
    "boolean_expressions": _gen_boolean,
    "multistep_arithmetic": _gen_arithmetic,
    "dyck_languages": _gen_dyck,
    "word_sorting": _gen_word_sorting,
    "web_of_lies": _gen_web_of_lies,
    "navigation": _gen_navigation,
    "zebra_puzzle": _gen_zebra,
    "sudoku": _gen_sudoku,
    "date_understanding": _gen_date,
}


def generate_problems(
    n: int, seed: int = 0, tasks: list[str] | None = None, dataset: str = "logic_synth"
) -> list[dict]:
    rng = random.Random(seed)
    names = tasks or sorted(_GENERATORS)
    problems = []
    for i in range(n):
        task_name = names[i % len(names)]
        p = _GENERATORS[task_name](rng)
        p.update({"dataset": dataset, "domain": DOMAIN, "id": f"{dataset}_{i}"})
        problems.append(p)
    return problems


def load_problems(dataset_names: list[str], **loader_kwargs: Any) -> list[dict]:
    """'train'/'test' (or 'logic_train'/'logic_test') → the synthetic sets of
    ``max_examples`` problems (512 by default)."""
    problems: list[dict] = []
    n = int(loader_kwargs.get("max_examples") or 512)
    for name in dataset_names:
        if name in ("train", "test", "logic_train", "logic_test"):
            seed = 0 if "train" in name else 1
            problems.extend(generate_problems(n, seed=seed, dataset=name))
        elif name.startswith("intellect3"):
            raise ValueError(
                f"logic dataset {name!r} is the INTELLECT-3 hub set, which needs dataset files that are not in "
                "the repository; use the synthetic 'train'/'test' sets"
            )
        else:
            raise ValueError(f"unknown logic dataset {name!r}")
    return problems
