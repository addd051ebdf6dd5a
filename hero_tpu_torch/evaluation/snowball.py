"""Snowball English ("Porter2") stemmer — pure python, dependency-free (a
verbatim copy of ``hero_tpu/evaluation/snowball.py``, held equal to it by
tests/test_torch_tvc_program.py).

The METEOR-1.5 jar's stem module uses the Snowball English stemmer
(``org.tartarus.snowball.ext.englishStemmer``; reference
``eval/pycocoevalcap/meteor/meteor.py`` + meteor-1.5 jar, Dockerfile:26-34),
NOT the original 1980 Porter algorithm — the two diverge on common words
("dying"→die vs di, "early"→earli, "skies"→sky, ...).  This implements the
published algorithm at snowballstem.org/algorithms/english/stemmer.html
with the Snowball runtime's marker semantics (R1/R2 positions clamp to the
end of a replacement that overlaps them), differential-tested against
NLTK's SnowballStemmer("english") over a 40k-word generated vocabulary
(tests/test_caption_metrics.py::test_snowball_matches_nltk).
"""

from __future__ import annotations

from functools import lru_cache

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = frozenset("cdeghkmnrt")

_EXCEPTIONS1 = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}
_EXCEPTIONS2 = frozenset(["inning", "outing", "canning", "herring",
                          "earring", "proceed", "exceed", "succeed"])

_STEP2 = [  # longest-match order
    ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
    ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
    ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
    ("ation", "ate"), ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
    ("iviti", "ive"), ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"),
    ("abli", "able"), ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
]
_STEP3 = [
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"), ("ness", ""),
    ("ful", ""),
]
_STEP4 = ["ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
          "ism", "ate", "iti", "ous", "ive", "ize", "ion", "al", "er",
          "ic"]


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _regions(word: str) -> tuple:
    """(R1 start, R2 start).  R1 = after the first non-vowel following a
    vowel; special prefixes gener-/commun-/arsen- pin R1."""
    n = len(word)
    r1 = n
    for pre in ("gener", "commun", "arsen"):
        if word.startswith(pre):
            r1 = len(pre)
            break
    else:
        for i in range(1, n):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    """Short syllable: non-vowel + vowel + non-vowel(≠ w,x,Y) at the end,
    or vowel + non-vowel at the start of a 2-letter word."""
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        return (not _is_vowel(word, n - 3) and _is_vowel(word, n - 2)
                and word[n - 1] not in _VOWELS
                and word[n - 1] not in "wxY")
    return False


def _has_vowel(word: str, end: int) -> bool:
    return any(_is_vowel(word, i) for i in range(end))


def _repl(word: str, r1: int, r2: int, n: int, rep: str):
    """Replace the last ``n`` chars with ``rep``.  Region markers stay at
    their absolute positions — the Snowball runtime sets p1/p2 once in
    mark_regions and never adjusts them on slice_from (the generated Java
    englishStemmer the METEOR jar embeds behaves this way; NLTK's
    string-truncation port diverges on some fabricated non-words)."""
    return word[:-n] + rep, r1, r2


@lru_cache(maxsize=65536)
def snowball_stem(word: str) -> str:
    word = word.lower()
    if len(word) <= 2:
        return word
    if word[0] == "'":
        word = word[1:]
    if word in _EXCEPTIONS1:
        return _EXCEPTIONS1[word]
    # mark consonant y as Y
    if word and word[0] == "y":
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)
    r1, r2 = _regions(word)

    # step 0: longest of ' 's 's'
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word, r1, r2 = _repl(word, r1, r2, len(suf), "")
            break

    # step 1a
    if word.endswith("sses"):
        word, r1, r2 = _repl(word, r1, r2, 4, "ss")
    elif word.endswith(("ied", "ies")):
        word, r1, r2 = _repl(word, r1, r2, 3,
                             "i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if _has_vowel(word, len(word) - 2):
            word, r1, r2 = _repl(word, r1, r2, 1, "")

    if word in _EXCEPTIONS2:
        return word

    # step 1b
    for suf in ("eedly", "eed"):
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word, r1, r2 = _repl(word, r1, r2, len(suf), "ee")
            break
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem = word[:-len(suf)]
                if _has_vowel(stem, len(stem)):
                    word, r1, r2 = _repl(word, r1, r2, len(suf), "")
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word, r1, r2 = _repl(word, r1, r2, 1, "")
                    elif r1 >= len(word) and _ends_short_syllable(word):
                        word += "e"
                break

    # step 1c: y/Y -> i if preceded by a non-vowel which is not the first
    # letter of the word
    if (len(word) > 2 and word[-1] in "yY"
            and word[-2] not in _VOWELS):
        word = word[:-1] + "i"

    # step 2 (suffix found in R1)
    for suf, rep in _STEP2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word, r1, r2 = _repl(word, r1, r2, len(suf), rep)
            break
    else:
        if word.endswith("ogi"):
            if (len(word) - 3 >= r1 and len(word) > 3
                    and word[-4] == "l"):
                word, r1, r2 = _repl(word, r1, r2, 3, "og")
        elif word.endswith("bli"):
            if len(word) - 3 >= r1:
                word, r1, r2 = _repl(word, r1, r2, 3, "ble")
        elif word.endswith("li"):
            if (len(word) - 2 >= r1 and len(word) > 2
                    and word[-3] in _LI_ENDING):
                word, r1, r2 = _repl(word, r1, r2, 2, "")

    # step 3 (suffix found in R1; 'ative' additionally requires R2)
    for suf, rep in _STEP3:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word, r1, r2 = _repl(word, r1, r2, len(suf), rep)
            break
    else:
        if word.endswith("ative"):
            if len(word) - 5 >= r2:
                word, r1, r2 = _repl(word, r1, r2, 5, "")

    # step 4 (suffix found in R2)
    for suf in _STEP4:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                if suf == "ion":
                    if len(word) > 3 and word[-4] in "st":
                        word, r1, r2 = _repl(word, r1, r2, 3, "")
                else:
                    word, r1, r2 = _repl(word, r1, r2, len(suf), "")
            break

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif (len(word) - 1 >= r1
              and not _ends_short_syllable(word[:-1])):
            word = word[:-1]
    elif word.endswith("l"):
        if len(word) - 1 >= r2 and len(word) > 1 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")
