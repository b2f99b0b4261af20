"""Research environment: a document corpus with search and read.

Port of the JAX package's ``domains/deep_research/environment.py``: the
corpus and its questions are deterministic from a seed (the same
``random.Random`` draws), so problems and documents always agree.
``ResearchEnvironment`` serves the corpus over HTTP as an
environment-server job, on the stdlib (``utils/http_json.py``).
"""

from __future__ import annotations

import random
import re
import threading
from dataclasses import dataclass, field

from ...utils.http_json import JsonServer

DOMAIN = "deep_research"

# synthetic world: entities with facts spread across documents so questions
# need 1-2 retrieval hops
_PLACES = ["Zorland", "Mirava", "Quenth", "Ostrev", "Balmora", "Tirsk",
           "Veyra", "Lunden", "Corvale", "Ashby"]
_PEOPLE = ["Ilya Korven", "Mara Senn", "Tobias Hale", "Runa Veld", "Ada Prost",
           "Nikolai Ferr", "Selma Odetta", "Viktor Lune"]
_FIELDS = ["cartography", "hydrology", "astronomy", "metallurgy", "botany",
           "linguistics", "seismology", "horology"]
_YEARS = list(range(1711, 1930))


@dataclass
class ResearchCorpus:
    documents: dict[str, dict] = field(default_factory=dict)  # id → {title, text}

    def search(self, query: str, k: int = 5) -> list[dict]:
        """Keyword search: score = count of query terms in title+text."""
        terms = [t for t in re.findall(r"\w+", query.lower()) if len(t) > 2]
        scored = []
        for doc_id, doc in self.documents.items():
            hay = (doc["title"] + " " + doc["text"]).lower()
            score = sum(hay.count(t) for t in terms)
            if score > 0:
                scored.append((score, doc_id))
        scored.sort(key=lambda x: (-x[0], x[1]))
        return [
            {
                "id": doc_id,
                "title": self.documents[doc_id]["title"],
                "snippet": self.documents[doc_id]["text"][:120],
            }
            for _, doc_id in scored[:k]
        ]

    def read(self, doc_id: str) -> str | None:
        doc = self.documents.get(doc_id)
        return doc["text"] if doc else None


def build_corpus(seed: int = 0, n_entities: int = 24) -> tuple[ResearchCorpus, list[dict]]:
    """Deterministic corpus + the question set grounded in it.

    Each entity gets a 'profile' doc plus facts scattered into other docs;
    two-hop questions chain person → field → place."""
    rng = random.Random(seed)
    corpus = ResearchCorpus()
    questions: list[dict] = []

    entities = []
    for i in range(n_entities):
        person = rng.choice(_PEOPLE) + f" {['I','II','III','IV'][rng.randrange(4)]}"
        place = rng.choice(_PLACES)
        fld = rng.choice(_FIELDS)
        year = rng.choice(_YEARS)
        entities.append({"person": person, "place": place, "field": fld, "year": year})

    for i, e in enumerate(entities):
        corpus.documents[f"doc_{i}a"] = {
            "title": f"Biography of {e['person']}",
            "text": (
                f"{e['person']} was a noted scholar of {e['field']}. "
                f"Born in {e['year']}, their early work reshaped the discipline."
            ),
        }
        corpus.documents[f"doc_{i}b"] = {
            "title": f"The {e['field']} institute",
            "text": (
                f"The principal institute of {e['field']} was founded in "
                f"{e['place']} and attracted scholars from across the region."
            ),
        }
        # distractor
        corpus.documents[f"doc_{i}c"] = {
            "title": f"Trade routes of {rng.choice(_PLACES)}",
            "text": f"A survey of caravan traffic compiled in {rng.choice(_YEARS)}.",
        }
        # one-hop question
        questions.append(
            {
                "task": f"In what year was {e['person']} born?",
                "answer": str(e["year"]),
                "hops": 1,
            }
        )
        # two-hop question: person → field → institute city
        questions.append(
            {
                "task": (
                    f"In which city was the principal institute of the field "
                    f"{e['person']} studied founded?"
                ),
                "answer": e["place"],
                "hops": 2,
            }
        )
    return corpus, questions


def load_problems(dataset_names: list[str], **loader_kwargs) -> list[dict]:
    n = int(loader_kwargs.get("max_examples") or 128)
    problems = []
    for name in dataset_names:
        seed = 0 if "train" in name else 1
        _, questions = build_corpus(seed=seed)
        for i, q in enumerate(questions[:n]):
            problems.append(
                {**q, "dataset": name, "domain": DOMAIN, "corpus_seed": seed,
                 "id": f"{name}_{i}"}
            )
    return problems


class ResearchEnvironment(JsonServer):
    """The corpus as an environment-server job: ``GET /search?q=&seed=`` →
    ``{results}``, ``GET /read?id=&seed=`` → ``{text}`` (404 for an unknown
    id), ``GET /health``; one corpus per seed, built on first use."""

    def __init__(self) -> None:
        super().__init__({("GET", "/search"): self.search, ("GET", "/read"): self.read}, name="research-environment")
        self.corpora: dict[int, ResearchCorpus] = {}
        self._lock = threading.Lock()

    def _corpus(self, seed: int) -> ResearchCorpus:
        with self._lock:
            if seed not in self.corpora:
                self.corpora[seed] = build_corpus(seed=seed)[0]
            return self.corpora[seed]

    def search(self, body, query: dict) -> tuple[int, dict]:
        return 200, {"results": self._corpus(int(query.get("seed", 0))).search(query.get("q", ""))}

    def read(self, body, query: dict) -> tuple[int, dict]:
        text = self._corpus(int(query.get("seed", 0))).read(query.get("id", ""))
        if text is None:
            return 404, {"error": "not found"}
        return 200, {"text": text}
