"""Caption metrics: BLEU-4, ROUGE-L, CIDEr-D, METEOR — all pure python (a
copy of ``hero_tpu/evaluation/caption_metrics.py``: the same inputs give
the same scores, held by tests/test_torch_tvc_program.py).

Replaces the reference's vendored ``eval/pycocoevalcap`` + Java jars
(``eval/tvc.py:17-51``, Dockerfile:26-34).  BLEU/ROUGE-L/CIDEr-D follow the
standard COCO-caption definitions (brevity penalty on the closest reference
length, corpus-level geometric mean for BLEU; CIDEr-D with length-gaussian
penalty, sigma 6.0, n=1..4, ×10 scaling) and are differential-tested
against pycocoevalcap.  METEOR is a dependency-free reimplementation of
the METEOR-1.5 English scoring (exact + Snowball-stem matcher stages,
1.5-en parameters and function-word discount; see :func:`meteor`).

Tokenization: the reference shells out to the Stanford PTBTokenizer jar.
:func:`ptb_tokenize` reimplements the Penn-Treebank rules + the
pycocoevalcap punctuation filter in python, golden-tested against known
jar outputs (tests/test_caption_metrics.py::PTB_GOLDEN).
"""

from __future__ import annotations

import math
import re
import shutil
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

from hero_tpu_torch.utils.logger import LOGGER

_PUNCT = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
          ".", "?", "!", ",", ":", "-", "--", "...", ";"]


# Penn-Treebank tokenization rules (Robert MacIntyre's public-domain
# tokenizer.sed contractions/punctuation conventions, which the Stanford
# PTBTokenizer follows for plain English text).  Order matters.
_PTB_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PTB_PUNCT_RULES = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),      # not inside numbers
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period (keeps abbreviation periods like u.s. attached)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PTB_BRACKETS = [
    (re.compile(r"\("), " -LRB- "), (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "), (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "), (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"--"), " -- "),
]
_PTB_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_PTB_CONTRACTIONS = [
    re.compile(r"\b(can)(not)\b", re.IGNORECASE),
    re.compile(r"\b(gon)(na)\b", re.IGNORECASE),
    re.compile(r"\b(got)(ta)\b", re.IGNORECASE),
    re.compile(r"\b(lem)(me)\b", re.IGNORECASE),
    re.compile(r"\b(wan)(na)\b", re.IGNORECASE),
    re.compile(r"\b(gim)(me)\b", re.IGNORECASE),
]


def ptb_tokenize_raw(text: str) -> List[str]:
    """Penn-Treebank word tokenization of one caption (the rules the
    Stanford PTBTokenizer applies to plain text), lowercased like the
    ``-lowerCase`` flag pycocoevalcap passes.  No punctuation filtering."""
    t = " " + text.replace("\n", " ") + " "
    for pat, rep in _PTB_STARTING_QUOTES:
        t = pat.sub(rep, t)
    for pat, rep in _PTB_PUNCT_RULES:
        t = pat.sub(rep, t)
    for pat, rep in _PTB_BRACKETS:
        t = pat.sub(rep, t)
    t = " " + t + " "
    for pat, rep in _PTB_ENDING_QUOTES:
        t = pat.sub(rep, t)
    for pat in _PTB_CONTRACTIONS:
        t = pat.sub(r"\1 \2", t)
    return t.lower().split()


def ptb_tokenize(text: str) -> List[str]:
    """PTB tokenization + pycocoevalcap's punctuation filter
    (``tokenizer/ptbtokenizer.py``: tokens in PUNCTUATIONS are dropped).

    Quirk preserved: the reference filter list holds UPPERCASE bracket
    tokens while the jar's -lowerCase output is lowercase, so ``-lrb-``
    etc. are NOT removed — we reproduce that exactly, since the filter
    feeds every caption metric."""
    return [w for w in ptb_tokenize_raw(text) if w not in _PUNCT]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU (corpus-level, COCO convention: closest ref length, method0 smoothing)
# ---------------------------------------------------------------------------

def bleu(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n over tokenized hypotheses/references."""
    tiny, small = 1e-15, 1e-9
    correct = [0.0] * max_n
    total = [0.0] * max_n
    hyp_len = 0
    ref_len = 0
    for key, hyp in res.items():
        refs = gts[key]
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r))
                       for r in refs)[1]
        for n in range(1, max_n + 1):
            h_ng = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            correct[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in h_ng.items())
            total[n - 1] += max(0, len(hyp) - n + 1)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len /
                                                max(hyp_len, 1))
    scores = []
    p_log_sum = 0.0
    for n in range(max_n):
        p = (correct[n] + tiny) / (total[n] + small)
        p_log_sum += math.log(p)
        scores.append(bp * math.exp(p_log_sum / (n + 1)))
    return scores


# ---------------------------------------------------------------------------
# ROUGE-L (COCO convention: beta=1.2, mean over refs... max over refs)
# ---------------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[-1], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(gts: Dict[str, List[List[str]]],
            res: Dict[str, List[str]], beta: float = 1.2) -> float:
    scores = []
    for key, hyp in res.items():
        precs, recs = [], []
        for ref in gts[key]:
            lcs = _lcs_len(hyp, ref)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(ref) if ref else 0.0)
        # COCO convention: max precision and max recall taken separately
        # across references, then combined
        p, r = max(precs), max(recs)
        if p and r:
            scores.append((1 + beta ** 2) * p * r / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]],
            n_max: int = 4, sigma: float = 6.0) -> float:
    # document frequencies over reference sets
    doc_freq = [Counter() for _ in range(n_max)]
    for refs in gts.values():
        for n in range(1, n_max + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n).keys())
            for ng in seen:
                doc_freq[n - 1][ng] += 1
    log_n_docs = math.log(max(len(gts), 1))

    def tfidf_vec(tokens):
        vecs, norms = [], []
        for n in range(1, n_max + 1):
            cnt = _ngrams(tokens, n)
            vec = {}
            norm = 0.0
            for ng, c in cnt.items():
                df = math.log(max(doc_freq[n - 1][ng], 1.0))
                w = c * (log_n_docs - df)
                vec[ng] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms

    scores = []
    for key, hyp in res.items():
        h_vecs, h_norms = tfidf_vec(hyp)
        score = [0.0] * n_max
        for ref in gts[key]:
            r_vecs, r_norms = tfidf_vec(ref)
            delta = len(hyp) - len(ref)
            for n in range(n_max):
                prod = sum(min(h_vecs[n].get(ng, 0.0), w) * w
                           for ng, w in r_vecs[n].items())
                if h_norms[n] and r_norms[n]:
                    s = prod / (h_norms[n] * r_norms[n])
                else:
                    s = 0.0
                s *= math.exp(-delta ** 2 / (2 * sigma ** 2))
                score[n] += s
        n_refs = max(len(gts[key]), 1)
        scores.append(10.0 * sum(sc / n_refs for sc in score) / n_max)
    return sum(scores) / max(len(scores), 1)


def meteor_available() -> bool:
    return shutil.which("java") is not None


# ---------------------------------------------------------------------------
# METEOR (pure python: METEOR-1.5 English semantics, exact + stem modules)
# ---------------------------------------------------------------------------
#
# The reference scores captions with the METEOR-1.5 jar run as
# ``java -jar meteor-1.5.jar - - -stdio -l en -norm``
# (``eval/pycocoevalcap/meteor/meteor.py``), i.e. the "Meteor Universal"
# English defaults (Denkowski & Lavie 2014): alpha=0.85, beta=0.2,
# gamma=0.6, delta=0.75, matcher weights exact=1.0 / stem=0.6 /
# synonym=0.8 / paraphrase=0.6, Snowball English stemmer, function-word
# discount.  This implementation reproduces all four matcher modules with
# those parameters and the delta-weighted content/function split; the
# synonym and paraphrase modules are DATA-GATED (the WordNet synsets and
# the ~60 MB paraphrase-en table do not ship in this zero-egress image) —
# without their data files they self-disable, which LOWERS scores
# slightly (a hypothesis word that only matches via synonymy counts as
# unmatched).  The emitted ``METEOR_variant`` key marks which modules ran.
#
# Scoring:  P = Σ_i w_i (δ·m_i(h_c) + (1−δ)·m_i(h_f)) / (δ|h_c| + (1−δ)|h_f|)
#           R = same over the reference;  Fmean = P·R / (α·P + (1−α)·R)
#           Pen = γ·(chunks / matches)^β;  score = (1 − Pen)·Fmean
# System score aggregates the sufficient statistics over segments, as the
# jar's MeteorStats accumulation does.

_MET_ALPHA, _MET_BETA, _MET_GAMMA, _MET_DELTA = 0.85, 0.2, 0.6, 0.75
# jar's en matcher weights: exact, stem, synonym, paraphrase
_MET_WEIGHTS = (1.0, 0.6, 0.8, 0.6)

# Synonym module (jar matcher weight 0.8): enabled when synonym data is
# available — either a meteor-style synsets file (lines ``word id id ...``)
# pointed to by $HERO_METEOR_SYNONYMS, or an installed NLTK WordNet corpus
# (the jar's synonymy is WordNet-derived).  Neither ships in this image
# (zero egress), so the stage self-disables and the variant marker says
# which modules ran.
_SYN_TABLE: Optional[Dict[str, frozenset]] = None
_SYN_SOURCE: Optional[str] = None
_SYN_LOADED = False


def _load_synonyms():
    """Lazy one-shot probe for synonym data; returns (table|None, source)."""
    global _SYN_TABLE, _SYN_SOURCE, _SYN_LOADED
    if _SYN_LOADED:
        return _SYN_TABLE, _SYN_SOURCE
    _SYN_LOADED = True
    import os
    path = os.environ.get("HERO_METEOR_SYNONYMS")
    if path and os.path.exists(path):
        table: Dict[str, set] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    table.setdefault(parts[0], set()).update(parts[1:])
        _SYN_TABLE = {w: frozenset(s) for w, s in table.items()}
        _SYN_SOURCE = "file"
        return _SYN_TABLE, _SYN_SOURCE
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("test")        # raises LookupError without data
        _SYN_TABLE = {}                # sentinel: query wordnet lazily
        _SYN_SOURCE = "wordnet"
    except Exception:
        _SYN_TABLE, _SYN_SOURCE = None, None
    return _SYN_TABLE, _SYN_SOURCE


def _synsets(word: str) -> frozenset:
    table, source = _load_synonyms()
    if source == "file":
        return table.get(word, frozenset())
    if source == "wordnet":
        if word not in table:
            from nltk.corpus import wordnet
            table[word] = frozenset(s.name() for s in wordnet.synsets(word))
        return table[word]
    return frozenset()


# Paraphrase module (jar matcher weight 0.6): enabled when a paraphrase
# table is available via $HERO_METEOR_PARAPHRASES.  The jar ships
# ``data/paraphrase-en.gz`` (~60 MB, built by pivoting bilingual phrase
# tables — Denkowski & Lavie 2010); it does not ship in this image (zero
# egress), so the stage self-disables without a file and the variant
# marker says so.  Accepted line formats (blank lines / ``#`` comments
# skipped):
#   ``phrase one ||| phrase two``              (meteor-style pair)
#   ``p ||| phrase one ||| phrase two [ ||| …]`` (PPDB-style; leading
#     probability field and any trailing fields ignored)
# Entries are symmetrized at load: the jar's pivot-built table contains
# both directions of nearly every pair, so a directional toy table would
# otherwise behave surprisingly in tests/small deployments.
_PARA_TABLE: Optional[Dict[tuple, frozenset]] = None
_PARA_MAX_LEN = 1
_PARA_LOADED = False


def _load_paraphrases():
    """Lazy one-shot probe for a paraphrase table; returns
    (table|None, max_phrase_len)."""
    global _PARA_TABLE, _PARA_MAX_LEN, _PARA_LOADED
    if _PARA_LOADED:
        return _PARA_TABLE, _PARA_MAX_LEN
    _PARA_LOADED = True
    import gzip
    import os
    path = os.environ.get("HERO_METEOR_PARAPHRASES")
    if not path or not os.path.exists(path):
        return None, 1
    table: Dict[tuple, set] = {}
    max_len = 1
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = [p.strip() for p in line.split("|||")]
            if len(fields) >= 3 and _is_number(fields[0]):
                a, b = fields[1], fields[2]       # PPDB: prob first
            elif len(fields) >= 2:
                a, b = fields[0], fields[1]
            else:
                continue
            ta, tb = tuple(a.lower().split()), tuple(b.lower().split())
            if not ta or not tb or ta == tb:
                continue
            table.setdefault(ta, set()).add(tb)
            table.setdefault(tb, set()).add(ta)
            max_len = max(max_len, len(ta), len(tb))
    _PARA_TABLE = {k: frozenset(v) for k, v in table.items()}
    _PARA_MAX_LEN = max_len
    return _PARA_TABLE, _PARA_MAX_LEN


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False

# Approximation of the jar's English function-word list (words with
# relative corpus frequency > 1e-3: closed-class words + clitics).  The
# exact file ships inside the jar; the discount mechanism and delta match
# the jar, the list membership is near-identical for caption vocabulary.
_MET_FUNCTION_WORDS = frozenset("""
a an the and or but if then than that this these those there here it its
he she his her him they them their we us our you your i me my is are was
were be been being am do does did have has had will would can could shall
should may might must not no nor so too very just also only all any some
such each both few more most other another in on at of to for with from
by as into over under about against between through during before after
above below up down out off again further once when where why how what
which who whom 's 't n't 'll 're 've 'm 'd
""".split())


def _meteor_align(hyp: List[str], ref: List[str]):
    """Stage-wise alignment (exact → stem → synonym → paraphrase, the
    data-gated modules only when their data is present), each hyp/ref
    word used at most once.  Ties prefer the ref position that CONTINUES
    the previous match run (the jar's beam aligner maximizes matches
    then minimizes chunks; this tie-break captures its dominant effect).
    Returns (align: hyp→ref word map, stage: hyp→module index,
    pmatches: list of (hi, hlen, ri, rlen) phrase-span matches from the
    paraphrase module).
    """
    from hero_tpu_torch.evaluation.snowball import snowball_stem

    def exact_cands(ht, r_keys, r_used):
        return [j for j, rt in enumerate(r_keys)
                if not r_used[j] and ht == rt]

    def syn_cands(hs, ref_sets, r_used):
        return [j for j, rs in enumerate(ref_sets)
                if not r_used[j] and hs and rs and (hs & rs)]

    stages = [(lambda t: t, exact_cands), (snowball_stem, exact_cands)]
    if _load_synonyms()[0] is not None:
        stages.append((_synsets, syn_cands))

    h_used = [False] * len(hyp)
    r_used = [False] * len(ref)
    align: Dict[int, int] = {}
    stage: Dict[int, int] = {}
    for si, (key, cands_fn) in enumerate(stages):
        r_keys = [key(t) for t in ref]
        for i, t in enumerate(hyp):
            if h_used[i]:
                continue
            cands = cands_fn(key(t), r_keys, r_used)
            if not cands:
                continue
            want = align.get(i - 1, -2) + 1   # continue the run if possible
            j = want if want in cands else cands[0]
            h_used[i] = True
            r_used[j] = True
            align[i] = j
            stage[i] = si
    pmatches = _paraphrase_matches(hyp, ref, h_used, r_used)
    return align, stage, pmatches


def _paraphrase_matches(hyp, ref, h_used, r_used):
    """Paraphrase module: greedy left-to-right, longest-hyp-span-first
    phrase matching over the words the word stages left unmatched.  A
    hyp span matches a ref span when the pair is in the paraphrase
    table; covered words on both sides are consumed.  Spans may differ
    in length (the jar's Match carries independent lengths)."""
    table, max_len = _load_paraphrases()
    out: List[tuple] = []
    if table is None:
        return out
    i = 0
    while i < len(hyp):
        if h_used[i]:
            i += 1
            continue
        placed = False
        for hlen in range(min(max_len, len(hyp) - i), 0, -1):
            if any(h_used[i:i + hlen]):
                continue
            paras = table.get(tuple(hyp[i:i + hlen]))
            if not paras:
                continue
            cands = []
            for pt in paras:
                rlen = len(pt)
                for j in range(len(ref) - rlen + 1):
                    if (not any(r_used[j:j + rlen])
                            and tuple(ref[j:j + rlen]) == pt):
                        cands.append((j, rlen))
            if not cands:
                continue
            # continue-the-run preference, else leftmost ref span
            want = None
            for (pi, plen, pj, prlen) in out:
                if pi + plen == i:
                    want = pj + prlen
            j, rlen = next(((j, rl) for j, rl in cands if j == want),
                           min(cands))
            for x in range(i, i + hlen):
                h_used[x] = True
            for x in range(j, j + rlen):
                r_used[x] = True
            out.append((i, hlen, j, rlen))
            i += hlen
            placed = True
            break
        if not placed:
            i += 1
    return out


def _chunks(align: Dict[int, int], pmatches: Sequence[tuple] = ()) -> int:
    """Chunk count over word matches + phrase-span matches: a new chunk
    starts whenever hyp or ref position is not contiguous with the
    previous match's span end (a phrase match is one contiguous block)."""
    spans = [(i, 1, j, 1) for i, j in align.items()]
    spans += list(pmatches)
    spans.sort()
    ch, prev = 0, None
    for (hi, hl, ri, rl) in spans:
        if (prev is None or hi != prev[0] + prev[1]
                or ri != prev[2] + prev[3]):
            ch += 1
        prev = (hi, hl, ri, rl)
    return ch


def _meteor_stats(hyp: List[str], ref: List[str]):
    """Sufficient statistics for one (hyp, ref) pair: delta-weighted
    match/length numerators for P and R, raw matches, chunks.  ``m`` is
    the average of covered-word counts over the two sides (equal for
    word matches; phrase matches may cover unequal spans)."""
    d = _MET_DELTA
    align, stage, pmatches = _meteor_align(hyp, ref)

    def w_len(tokens):
        c = sum(1 for t in tokens if t not in _MET_FUNCTION_WORDS)
        f = len(tokens) - c
        return d * c + (1 - d) * f

    def w_tok(t):
        return d if t not in _MET_FUNCTION_WORDS else (1 - d)

    w_h = w_r = 0.0
    for i, j in align.items():
        wi = _MET_WEIGHTS[stage[i]]
        w_h += wi * w_tok(hyp[i])
        w_r += wi * w_tok(ref[j])
    cov_h = cov_r = len(align)
    w_para = _MET_WEIGHTS[3]
    for (hi, hl, ri, rl) in pmatches:
        w_h += w_para * sum(w_tok(t) for t in hyp[hi:hi + hl])
        w_r += w_para * sum(w_tok(t) for t in ref[ri:ri + rl])
        cov_h += hl
        cov_r += rl
    return {"w_h": w_h, "w_r": w_r, "len_h": w_len(hyp),
            "len_r": w_len(ref), "m": (cov_h + cov_r) / 2,
            "ch": _chunks(align, pmatches)}


def _meteor_score(st) -> float:
    if not st["len_h"] or not st["len_r"] or not st["m"]:
        return 0.0
    p = st["w_h"] / st["len_h"]
    r = st["w_r"] / st["len_r"]
    if p + r == 0:
        return 0.0
    f = p * r / (_MET_ALPHA * p + (1 - _MET_ALPHA) * r)
    pen = _MET_GAMMA * (st["ch"] / st["m"]) ** _MET_BETA
    return (1 - pen) * f


def meteor(gts: Dict[str, List[List[str]]], res: Dict[str, List[str]]
           ) -> float:
    """Corpus METEOR over tokenized hypotheses/references (best reference
    per segment by segment score; system score from summed statistics)."""
    tot = {"w_h": 0.0, "w_r": 0.0, "len_h": 0.0, "len_r": 0.0,
           "m": 0, "ch": 0}
    for key, hyp in res.items():
        best = None
        for ref in gts[key]:
            st = _meteor_stats(hyp, ref)
            if best is None or _meteor_score(st) > _meteor_score(best):
                best = st
        if best is None:
            continue
        for k in tot:
            tot[k] += best[k]
    return _meteor_score(tot)


class TVCEval:
    """Caption evaluator (reference eval/tvc.py:17-51): preload refs, score
    a submission of {"clip_id": ..., "descs": [{"desc": str}]} records."""

    def __init__(self, ref_jsonl_path: str):
        import json
        self.gts: Dict[str, List[List[str]]] = {}
        with open(ref_jsonl_path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                cid = str(d["clip_id"])
                self.gts[cid] = [ptb_tokenize(e["desc"])
                                 for e in d["descs"]]

    def __call__(self, submission: List[dict]) -> Dict[str, float]:
        res = {}
        for d in submission:
            cid = str(d["clip_id"])
            if cid in self.gts:
                res[cid] = ptb_tokenize(d["descs"][0]["desc"])
        gts = {k: self.gts[k] for k in res}
        bleu_scores = bleu(gts, res)
        out = {
            "Bleu@4": round(bleu_scores[3], 4),
            "ROUGE-L": round(rouge_l(gts, res), 4),
            "CIDEr": round(cider_d(gts, res), 4),
        }
        # pure-python METEOR (exact + Snowball-stem modules, METEOR-1.5 en
        # parameters + function-word discount; see the section comment for
        # the delta vs the jar).  The variant marker makes the non-jar
        # provenance visible in emitted result tables, not only in docs
        # (ADVICE r2): numbers are not comparable to jar-produced METEOR
        # at the second decimal (no WordNet synonym/paraphrase stages).
        out["METEOR"] = round(meteor(gts, res), 4)
        out["METEOR_variant"] = meteor_variant()
        return out


def meteor_variant() -> str:
    """Self-describing provenance string for pure-python METEOR scores:
    which data-gated modules (synonym/paraphrase) were active.  Threaded
    into every artifact that carries a METEOR number (TVCEval output,
    inf_tvc score files) so published numbers are comparable-or-marked."""
    syn_src = _load_synonyms()[1]
    para = _load_paraphrases()[0] is not None
    mods = "python meteor-1.5-en exact+snowball"
    if syn_src:
        mods += f"+synonym[{syn_src}]"
    if para:
        mods += "+paraphrase[file]"
    missing = [m for m, on in (("synonym", syn_src), ("paraphrase", para))
               if not on]
    if missing:
        mods += f" (no {'/'.join(missing)})"
    return mods
