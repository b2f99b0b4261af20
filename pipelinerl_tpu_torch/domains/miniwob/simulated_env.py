"""Self-contained MiniWoB-like web tasks: a text DOM and bid-addressed
actions.

Port of the JAX package's ``domains/miniwob/simulated_env.py``: the same
four ``simweb.*`` tasks, built from the same ``random.Random(seed)`` draws,
with the same checks and episode contract (``REWARD_GLOBAL`` in
``task_info``): ``SimulatedWebEnv(task, seed)``, ``observe()`` and
``step(action)`` → (observation, done, info). Actions take the BrowserGym
high-level form: ``click("bid")``, ``fill("bid", "text")``,
``select_option("bid", "option")``.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass, field

_ACTION_RE = re.compile(
    r"(click|fill|select_option)\s*\(\s*[\"']?(\w+)[\"']?\s*"
    r"(?:,\s*[\"']?([^\"')]*)[\"']?)?\s*\)"
)


@dataclass
class SimulatedTask:
    goal: str
    dom: dict  # bid → element dict(tag, text, checked/value/options...)
    check: object  # fn(env) -> bool
    max_steps: int = 8


@dataclass
class SimulatedWebEnv:
    task_name: str
    seed: int
    task: SimulatedTask = field(init=False)
    steps_taken: int = 0
    done: bool = False
    reward: float = 0.0

    def __post_init__(self) -> None:
        maker = TASKS.get(self.task_name)
        if maker is None:
            raise KeyError(f"unknown simulated task {self.task_name!r}")
        self.task = maker(random.Random(self.seed))

    # -- observation ---------------------------------------------------------
    def observe(self) -> str:
        lines = [f"GOAL: {self.task.goal}", "DOM:"]
        for bid, el in self.task.dom.items():
            attrs = []
            if "checked" in el:
                attrs.append(f"checked={el['checked']}")
            if "value" in el:
                attrs.append(f"value={el['value']!r}")
            if "options" in el:
                attrs.append(f"options={el['options']}")
            lines.append(
                f"  [{bid}] <{el['tag']}> {el.get('text', '')} "
                + " ".join(attrs)
            )
        return "\n".join(lines)

    # -- actions --------------------------------------------------------------
    def step(self, action: str) -> tuple[str, bool, dict]:
        """Returns (observation, done, info). Unparsable/invalid actions set
        info['action_error'] (the reference counts these as step errors)."""
        self.steps_taken += 1
        info: dict = {}
        m = _ACTION_RE.search(action or "")
        if not m:
            info["action_error"] = f"could not parse action: {action!r}"
        else:
            op, bid, arg = m.group(1), m.group(2), m.group(3)
            el = self.task.dom.get(bid)
            if el is None:
                info["action_error"] = f"no element with bid {bid!r}"
            elif op == "click":
                if el["tag"] == "checkbox":
                    el["checked"] = not el.get("checked", False)
                elif el["tag"] in ("button", "link"):
                    el["clicked"] = True
                    if el.get("submits"):
                        self.done = True
            elif op == "fill":
                if "value" in el:
                    el["value"] = arg or ""
                else:
                    info["action_error"] = f"element {bid} is not fillable"
            elif op == "select_option":
                if "options" in el and arg in el["options"]:
                    el["value"] = arg
                else:
                    info["action_error"] = f"cannot select {arg!r} on {bid}"
        if self.steps_taken >= self.task.max_steps:
            self.done = True
        if self.done:
            self.reward = 1.0 if self.task.check(self) else -1.0
        info["task_info"] = {"REWARD_GLOBAL": self.reward if self.done else 0.0}
        return self.observe(), self.done, info


# ---------------------------------------------------------------------------
# task generators
# ---------------------------------------------------------------------------

_WORDS = ["alpha", "bravo", "carbon", "delta", "ember", "falcon", "garnet",
          "harbor", "indigo", "jasper"]


def _click_button(rng: random.Random) -> SimulatedTask:
    labels = rng.sample(_WORDS, 4)
    target = rng.choice(labels)
    dom = {
        f"b{i}": {"tag": "button", "text": lab, "submits": True}
        for i, lab in enumerate(labels)
    }

    def check(env: SimulatedWebEnv) -> bool:
        clicked = [b for b in env.task.dom.values() if b.get("clicked")]
        return len(clicked) == 1 and clicked[0]["text"] == target

    return SimulatedTask(goal=f'Click the "{target}" button.', dom=dom, check=check)


def _click_checkboxes(rng: random.Random) -> SimulatedTask:
    labels = rng.sample(_WORDS, 5)
    wanted = set(rng.sample(labels, rng.randint(1, 3)))
    dom = {
        f"c{i}": {"tag": "checkbox", "text": lab, "checked": False}
        for i, lab in enumerate(labels)
    }
    dom["submit"] = {"tag": "button", "text": "Submit", "submits": True}

    def check(env: SimulatedWebEnv) -> bool:
        return all(
            el["tag"] != "checkbox" or el["checked"] == (el["text"] in wanted)
            for el in env.task.dom.values()
        )

    return SimulatedTask(
        goal="Check the boxes labeled " + ", ".join(sorted(wanted))
        + " then click Submit.",
        dom=dom,
        check=check,
    )


def _enter_text(rng: random.Random) -> SimulatedTask:
    word = rng.choice(_WORDS)
    dom = {
        "input": {"tag": "input", "text": "", "value": ""},
        "submit": {"tag": "button", "text": "Submit", "submits": True},
    }

    def check(env: SimulatedWebEnv) -> bool:
        return env.task.dom["input"]["value"] == word

    return SimulatedTask(
        goal=f'Type "{word}" into the text field and click Submit.',
        dom=dom, check=check,
    )


def _choose_list(rng: random.Random) -> SimulatedTask:
    options = rng.sample(_WORDS, 5)
    target = rng.choice(options)
    dom = {
        "list": {"tag": "select", "text": "", "options": options, "value": ""},
        "submit": {"tag": "button", "text": "Submit", "submits": True},
    }

    def check(env: SimulatedWebEnv) -> bool:
        return env.task.dom["list"]["value"] == target

    return SimulatedTask(
        goal=f'Select "{target}" from the list and click Submit.',
        dom=dom, check=check,
    )


TASKS = {
    "simweb.click-button": _click_button,
    "simweb.click-checkboxes": _click_checkboxes,
    "simweb.enter-text": _enter_text,
    "simweb.choose-list": _choose_list,
}
