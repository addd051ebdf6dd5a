"""Tokenization for prepro (a copy of ``hero_tpu/prepro/tokenize.py``;
reference ``scripts/prepro_sub.py:246-253``): html-unescape, lowercase
ALL-CAPS text, then RoBERTa's BPE, or the deterministic hash tokenizer.

One deliberate difference: :func:`get_tokenizer` never swaps the hash
tokenizer in for RoBERTa.  The JAX version does so quietly when the
vocabulary is missing, and then writes stores whose ids do not match the
released checkpoint's vocabulary; the port raises instead."""

from __future__ import annotations

import html
import zlib
from typing import Callable, List

ROBERTA_VOCAB = 50265          # roberta-base's tokens, specials included


def _normalize(text: str) -> str:
    text = html.unescape(text)
    return text.lower() if text.isupper() else text


def load_roberta():
    """``transformers``' ``RobertaTokenizer`` from the local
    ``roberta-base`` files (never downloaded).  Raises ``OSError`` when
    ``transformers`` or the files are missing, or when what loads lacks
    roberta-base's vocabulary (an offline ``transformers`` 5 builds a
    tokenizer of its special tokens alone)."""
    try:
        from transformers import RobertaTokenizer
    except ImportError as e:
        raise OSError(f"transformers is not installed ({e})") from e
    try:
        tok = RobertaTokenizer.from_pretrained("roberta-base",
                                               local_files_only=True)
    except Exception as e:     # transformers' many ways to find no files
        raise OSError(f"roberta-base did not load from the local cache "
                      f"({type(e).__name__}: {e})") from e
    if len(tok) < ROBERTA_VOCAB:
        raise OSError(f"the roberta-base tokenizer in the cache has "
                      f"{len(tok)} tokens, not {ROBERTA_VOCAB}")
    return tok


def roberta_tokenizer() -> Callable[[str], List[int]]:
    """RoBERTa's BPE ids of the normalized text (:func:`load_roberta`)."""
    tok = load_roberta()

    def fn(text: str) -> List[int]:
        return tok.convert_tokens_to_ids(tok.tokenize(_normalize(text)))
    return fn


def hash_tokenizer(vocab_range=(3, 50260)) -> Callable[[str], List[int]]:
    """One id a whitespace word: ``lo + crc32(word) % (hi - lo)``."""
    lo, hi = vocab_range

    def fn(text: str) -> List[int]:
        return [lo + (zlib.crc32(w.encode()) % (hi - lo))
                for w in _normalize(text).split()]
    return fn


def get_tokenizer(name: str = "roberta") -> Callable[[str], List[int]]:
    """``"roberta"`` or ``"hash"``.  RoBERTa without its local vocabulary
    raises (no fallback)."""
    if name == "roberta":
        try:
            return roberta_tokenizer()
        except OSError as e:
            raise RuntimeError(
                f"the RoBERTa tokenizer needs the roberta-base vocabulary "
                f"in the local Hugging Face cache ($HF_HOME), which is "
                f"never downloaded: {e}. Put roberta-base's tokenizer "
                f"files there, or pass --tokenizer hash for ids that do "
                f"not match the released checkpoint's vocabulary") from e
    if name == "hash":
        return hash_tokenizer()
    raise ValueError(f"tokenizer {name!r}: roberta or hash")
