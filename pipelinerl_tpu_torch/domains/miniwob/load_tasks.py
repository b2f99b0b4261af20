"""MiniWoB task loading: the (task, seed) grid of each split.

Port of the JAX package's ``domains/miniwob/load_tasks.py``: the
``simweb_train`` and ``simweb_test`` splits of the simulated tasks (test
seeds from 10,000), and the ``debug`` and ``easy`` splits of real MiniWoB
task names, which need BrowserGym behind an environment server (gated off
in both packages where BrowserGym is absent, as on the card host).
``n_seeds`` seeds per task.
"""

from __future__ import annotations

DOMAIN = "miniwob"

SIMWEB_SPLIT = [
    "simweb.click-button",
    "simweb.click-checkboxes",
    "simweb.enter-text",
    "simweb.choose-list",
]

# reference splits (usable when browsergym is installed; names per
# reference load_tasks.py:5-36)
DEBUG_SPLIT = [
    "miniwob.buy-ticket",
    "miniwob.bisect-angle",
    "miniwob.choose-list",
    "miniwob.click-checkboxes-large",
    "miniwob.click-checkboxes-soft",
]
EASY_SPLIT = [
    "miniwob.click-color",
    "miniwob.click-test-2",
    "miniwob.click-test-transfer",
    "miniwob.enter-password",
    "miniwob.focus-text-2",
    "miniwob.identify-shape",
    "miniwob.navigate-tree",
    "miniwob.phone-book",
    "miniwob.read-table",
    "miniwob.use-autocomplete",
]

SPLITS = {
    "simweb_train": SIMWEB_SPLIT,
    "simweb_test": SIMWEB_SPLIT,
    "debug": DEBUG_SPLIT,
    "easy": EASY_SPLIT,
}


def load_tasks(dataset_names: list[str], **loader_kwargs) -> list[dict]:
    n_seeds = int(loader_kwargs.get("n_seeds", 16))
    problems = []
    for name in dataset_names:
        tasks = SPLITS.get(name)
        if tasks is None:
            raise ValueError(f"unknown miniwob split {name!r} (have {sorted(SPLITS)})")
        seed_base = 10_000 if name.endswith("test") else 0
        for task in tasks:
            for seed in range(n_seeds):
                problems.append(
                    {
                        "task": task,
                        "seed": seed_base + seed,
                        "dataset": name,
                        "domain": DOMAIN,
                    }
                )
    return problems
