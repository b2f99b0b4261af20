"""Verifiable-instruction checkers (IFEval instruction taxonomy).

Each checker: (response, kwargs) → bool. Instruction ids follow the
IFEval naming (e.g. ``keywords:existence``) so IFEval-format datasets work
directly. A copy of the JAX package's ``domains/ifeval/checkers.py``.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable


def _words(text: str) -> list[str]:
    return re.findall(r"[A-Za-z0-9']+", text)


def _sentences(text: str) -> list[str]:
    parts = re.split(r"[.!?]+(?:\s|$)", text)
    return [p for p in parts if p.strip()]


def _paragraphs(text: str, sep: str = "\n\n") -> list[str]:
    return [p for p in text.split(sep) if p.strip()]


def _rel(count: int, relation: str, target: int) -> bool:
    if relation == "at least":
        return count >= target
    if relation == "at most":
        return count <= target
    if relation in ("exactly", None, ""):
        return count == target
    if relation == "less than":
        return count < target
    if relation == "more than":
        return count > target
    raise ValueError(f"Unknown relation {relation!r}")


# -- keywords ----------------------------------------------------------------


def keywords_existence(response: str, *, keywords: list[str], **_) -> bool:
    low = response.lower()
    return all(k.lower() in low for k in keywords)


def keywords_frequency(
    response: str, *, keyword: str, frequency: int, relation: str = "at least", **_
) -> bool:
    count = len(re.findall(re.escape(keyword.lower()), response.lower()))
    return _rel(count, relation, frequency)


def keywords_forbidden(response: str, *, forbidden_words: list[str], **_) -> bool:
    low = response.lower()
    return not any(
        re.search(rf"\b{re.escape(w.lower())}\b", low) for w in forbidden_words
    )


def keywords_letter_frequency(
    response: str, *, letter: str, let_frequency: int, let_relation: str = "at least", **_
) -> bool:
    count = response.lower().count(letter.lower())
    return _rel(count, let_relation, let_frequency)


# -- length constraints ------------------------------------------------------


def length_number_words(
    response: str, *, num_words: int, relation: str = "at least", **_
) -> bool:
    return _rel(len(_words(response)), relation, num_words)


def length_number_sentences(
    response: str, *, num_sentences: int, relation: str = "at least", **_
) -> bool:
    return _rel(len(_sentences(response)), relation, num_sentences)


def length_number_paragraphs(response: str, *, num_paragraphs: int, **_) -> bool:
    return len(_paragraphs(response, "***")) == num_paragraphs


def length_nth_paragraph_first_word(
    response: str, *, num_paragraphs: int, nth_paragraph: int, first_word: str, **_
) -> bool:
    paras = _paragraphs(response)
    if len(paras) != num_paragraphs or nth_paragraph > len(paras):
        return False
    words = _words(paras[nth_paragraph - 1])
    return bool(words) and words[0].lower() == first_word.lower()


# -- detectable content ------------------------------------------------------


def content_number_placeholders(response: str, *, num_placeholders: int, **_) -> bool:
    return len(re.findall(r"\[[^\[\]]+\]", response)) >= num_placeholders


def content_postscript(response: str, *, postscript_marker: str = "P.S.", **_) -> bool:
    marker = postscript_marker.replace(".", r"\.?").replace(" ", r"\s?")
    return re.search(rf"\s*{marker}", response, re.IGNORECASE) is not None


# -- detectable format -------------------------------------------------------


def format_number_bullets(response: str, *, num_bullets: int, **_) -> bool:
    bullets = re.findall(r"^\s*[*-]\s", response, re.MULTILINE)
    return len(bullets) == num_bullets


def format_title(response: str, **_) -> bool:
    return re.search(r"<<[^<>]+>>", response) is not None


def format_json(response: str, **_) -> bool:
    text = response.strip()
    m = re.search(r"```(?:json)?\s*\n(.*?)```", text, re.S)
    if m:
        text = m.group(1).strip()
    try:
        json.loads(text)
        return True
    except json.JSONDecodeError:
        return False


def format_number_highlighted(response: str, *, num_highlights: int, **_) -> bool:
    highlights = re.findall(r"\*[^*\n]+\*", response)
    return len(highlights) >= num_highlights


def format_multiple_sections(
    response: str, *, section_spliter: str = "Section", num_sections: int = 1, **_
) -> bool:
    found = re.findall(rf"{re.escape(section_spliter)}\s+\d+", response)
    return len(found) >= num_sections


def format_constrained_response(response: str, **_) -> bool:
    options = ("My answer is yes.", "My answer is no.", "My answer is maybe.")
    return any(o in response for o in options)


# -- start/end ---------------------------------------------------------------


def startend_quotation(response: str, **_) -> bool:
    text = response.strip()
    return len(text) >= 2 and text.startswith('"') and text.endswith('"')


def startend_end_checker(response: str, *, end_phrase: str, **_) -> bool:
    return response.strip().lower().endswith(end_phrase.strip().lower())


# -- case / punctuation / combination ---------------------------------------


def case_lowercase(response: str, **_) -> bool:
    return response == response.lower()


def case_capital(response: str, **_) -> bool:
    return response == response.upper()


def case_capital_word_frequency(
    response: str, *, capital_frequency: int, capital_relation: str = "at least", **_
) -> bool:
    count = sum(1 for w in _words(response) if w.isupper() and len(w) > 1)
    return _rel(count, capital_relation, capital_frequency)


def punctuation_no_comma(response: str, **_) -> bool:
    return "," not in response


def combination_repeat_prompt(response: str, *, prompt_to_repeat: str, **_) -> bool:
    return response.strip().startswith(prompt_to_repeat.strip())


def combination_two_responses(response: str, **_) -> bool:
    return "******" in response


CHECKERS: dict[str, Callable[..., bool]] = {
    "keywords:existence": keywords_existence,
    "keywords:frequency": keywords_frequency,
    "keywords:forbidden_words": keywords_forbidden,
    "keywords:letter_frequency": keywords_letter_frequency,
    "length_constraints:number_words": length_number_words,
    "length_constraints:number_sentences": length_number_sentences,
    "length_constraints:number_paragraphs": length_number_paragraphs,
    "length_constraints:nth_paragraph_first_word": length_nth_paragraph_first_word,
    "detectable_content:number_placeholders": content_number_placeholders,
    "detectable_content:postscript": content_postscript,
    "detectable_format:number_bullet_lists": format_number_bullets,
    "detectable_format:title": format_title,
    "detectable_format:json_format": format_json,
    "detectable_format:number_highlighted_sections": format_number_highlighted,
    "detectable_format:multiple_sections": format_multiple_sections,
    "detectable_format:constrained_response": format_constrained_response,
    "startend:quotation": startend_quotation,
    "startend:end_checker": startend_end_checker,
    "change_case:english_lowercase": case_lowercase,
    "change_case:english_capital": case_capital,
    "change_case:capital_word_frequency": case_capital_word_frequency,
    "punctuation:no_comma": punctuation_no_comma,
    "combination:repeat_prompt": combination_repeat_prompt,
    "combination:two_responses": combination_two_responses,
}


def check_instruction(response: str, instruction_id: str, kwargs: dict[str, Any] | None) -> bool:
    checker = CHECKERS.get(instruction_id)
    if checker is None:
        raise KeyError(f"Unknown instruction {instruction_id!r}")
    clean = {k: v for k, v in (kwargs or {}).items() if v is not None}
    return bool(checker(response, **clean))
