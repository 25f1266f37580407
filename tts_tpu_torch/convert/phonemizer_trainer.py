"""Trainable rules-based phonemizer: induce grapheme->IPA rules + exception
dictionary from a (word -> phoneme) lexicon, exportable to the GGUF tables the
runtime phonemizer consumes (phonemizer.rules.* / phonemizer.dictionary.*).

The port's own copy of `tts_tpu/convert/phonemizer_trainer.py` (host code
over the port's `text/phonemizer.py`, `SinglePassTokenizer` and
`phoneme_data`): the same lexicon gives the same rules and a byte-identical
GGUF.

The reference trains against espeak over the NLTK corpus
(its phonemization_training); this implementation is
source-agnostic — feed it any lexicon (espeak dumps, CMUdict->IPA, or a
hand-made set).  Pipeline:

1. align each word's graphemes to a split of its phoneme string (DP over
   per-grapheme phoneme chunks, scored by global chunk frequencies, iterated
   EM-style);
2. emit a default rule per grapheme (most common chunk), then contextual
   rules keyed on (before, after) graphemes where the default disagrees, then
   word-scoped rules, exactly the lookup hierarchy `WordPhonemizer` resolves
   (text/phonemizer.py RuleNode: [before, after, word]);
3. words still mispredicted become dictionary exceptions.

The result reproduces the training lexicon exactly and generalizes through
the learned rules for unseen words.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict

from tts_tpu_torch.text.phonemizer import PhonemeDictionary, Phonemizer, WordPhonemizer
from tts_tpu_torch.text.tokenizers import SinglePassTokenizer

MAX_CHUNK = 4  # max IPA characters a single grapheme may map to


def _splits(phonemes: str, n_graphemes: int):
    """DP lattice helper: enumerate chunk lengths 0..MAX_CHUNK per grapheme."""
    return range(0, MAX_CHUNK + 1)


def align_word(graphemes: list[str], phonemes: str, chunk_scores) -> list[str] | None:
    """Split `phonemes` into len(graphemes) chunks (each 0..MAX_CHUNK chars)
    maximizing the sum of chunk_scores[(g, chunk)].  Returns chunks or None."""
    n, m = len(graphemes), len(phonemes)
    NEG = float("-inf")
    # dp[i][j] = best score aligning first i graphemes to first j phoneme chars
    dp = [[NEG] * (m + 1) for _ in range(n + 1)]
    back = [[0] * (m + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for i in range(1, n + 1):
        g = graphemes[i - 1]
        for j in range(m + 1):
            for k in _splits(phonemes, n):
                if k > j or dp[i - 1][j - k] == NEG:
                    continue
                chunk = phonemes[j - k : j]
                score = dp[i - 1][j - k] + chunk_scores(g, chunk)
                if score > dp[i][j]:
                    dp[i][j] = score
                    back[i][j] = k
    if dp[n][m] == NEG:
        return None
    chunks = []
    j = m
    for i in range(n, 0, -1):
        k = back[i][j]
        chunks.append(phonemes[j - k : j])
        j -= k
    chunks.reverse()
    return chunks


class PhonemizerTrainer:
    def __init__(self, graphemes: list[str] | None = None):
        self.graphemes = graphemes
        self.rules: dict = {}
        self.exceptions: dict[str, str] = {}
        self.tokenizer: SinglePassTokenizer | None = None

    # -- training ------------------------------------------------------------
    def train(self, lexicon: dict[str, str], iterations: int = 3) -> dict:
        """lexicon: lowercase word -> IPA.  Returns summary stats."""
        if self.graphemes is None:
            self.graphemes = sorted({c for w in lexicon for c in w})
        self.tokenizer = SinglePassTokenizer(self.graphemes)
        words = {w: (self.tokenizer.token_split(w), p) for w, p in lexicon.items()}

        # EM over alignments: chunk frequencies <-> best alignments
        freq: Counter = Counter()

        def score_fn(g, chunk):
            # favor frequent (g, chunk) pairs; mild length prior toward 1-2
            base = freq.get((g, chunk), 0)
            length_prior = {0: -2.0, 1: 0.0, 2: -0.2, 3: -0.6, 4: -1.0}[len(chunk)]
            return base * 0.05 + length_prior

        alignments: dict[str, list[str]] = {}
        for _ in range(iterations):
            freq_next: Counter = Counter()
            for w, (gs, ph) in words.items():
                chunks = align_word(gs, ph, score_fn)
                if chunks is None:
                    continue
                alignments[w] = chunks
                for g, c in zip(gs, chunks):
                    freq_next[(g, c)] += 1
            freq = freq_next

        # hierarchical rules: default per grapheme, then (before, after)
        # contexts, then word-scoped — matching WordPhonemizer lookup order
        by_context: dict = defaultdict(Counter)
        for w, (gs, ph) in words.items():
            chunks = alignments.get(w)
            if chunks is None:
                continue
            for i, (g, c) in enumerate(zip(gs, chunks)):
                before = gs[i - 1] if i > 0 else "^"
                after = gs[i + 1] if i + 1 < len(gs) else "$"
                by_context[g][(None, None, c)] += 1
                by_context[g][(before, after, c)] += 1

        self.rules = {}
        for g, ctr in by_context.items():
            default_votes = Counter()
            for (b, a, c), n in ctr.items():
                if b is None:
                    default_votes[c] += n
            default_chunk = default_votes.most_common(1)[0][0] if default_votes else ""
            self.rules[g] = {"default": default_chunk, "context": {}, "word": {}}
            # contextual overrides where a (before, after) majority differs
            ctx_votes: dict = defaultdict(Counter)
            for (b, a, c), n in ctr.items():
                if b is not None:
                    ctx_votes[(b, a)][c] += n
            for (b, a), votes in ctx_votes.items():
                winner, _ = votes.most_common(1)[0]
                if winner != default_chunk:
                    self.rules[g]["context"][(b, a)] = winner

        # word-level rules + dictionary exceptions for remaining mismatches
        wp = self.build_word_phonemizer()
        for w, (gs, ph) in words.items():
            if wp.phonemize(w) != ph:
                chunks = alignments.get(w)
                if chunks is not None:
                    for i, (g, c) in enumerate(zip(gs, chunks)):
                        before = gs[i - 1] if i > 0 else "^"
                        after = gs[i + 1] if i + 1 < len(gs) else "$"
                        self.rules[g]["word"][(before, after, w)] = c
        wp = self.build_word_phonemizer()
        from tts_tpu_torch.text.phoneme_data import SMALL_ENGLISH_WORDS
        for w, (gs, ph) in words.items():
            if wp.phonemize(w) != ph:
                self.exceptions[w] = ph
            elif len(w) < 4 and w not in SMALL_ENGLISH_WORDS:
                # short unknown words would route to the acronym speller
                # (phonemizer.is_acronym_like); pin them in the dictionary
                self.exceptions[w] = ph

        correct = sum(1 for w, (gs, ph) in words.items()
                      if wp.phonemize(w) == ph or self.exceptions.get(w) == ph)
        return {"words": len(words), "covered": correct,
                "rules": sum(1 + len(r["context"]) + len(r["word"])
                             for r in self.rules.values()),
                "exceptions": len(self.exceptions)}

    # -- export --------------------------------------------------------------
    def export_tables(self) -> dict:
        """GGUF KV tables in the format phonemizer_from_gguf consumes
        (rules keyed 'g', 'g.before', 'g.before.after', 'g.before.after.word')."""
        keys, phonemes = [], []
        for g, r in self.rules.items():
            default = r["default"]
            keys.append(g)
            phonemes.append(default)
            # intermediate trie nodes need explicit fallback values: a lookup
            # that matches `before` but not `after` returns that node's value
            # (text/phonemizer.py RuleNode.lookup, parity with the reference)
            befores = ({b for (b, a) in r["context"]}
                       | {b for (b, a, w) in r["word"]})
            for b in befores:
                keys.append(f"{g}.{b}")
                phonemes.append(default)
            pairs = ({(b, a) for (b, a) in r["context"]}
                     | {(b, a) for (b, a, w) in r["word"]})
            for b, a in pairs:
                keys.append(f"{g}.{b}.{a}")
                phonemes.append(r["context"].get((b, a), default))
            for (b, a, w), c in r["word"].items():
                keys.append(f"{g}.{b}.{a}.{w}")
                phonemes.append(c)
        return {
            "phonemizer.type": 0,
            "phonemizer.phoneme_type": 1,
            "phonemizer.graphemes": list(self.graphemes),
            "phonemizer.rules.keys": keys,
            "phonemizer.rules.phonemes": phonemes,
            "phonemizer.dictionary.keys": list(self.exceptions),
            "phonemizer.dictionary.values": list(self.exceptions.values()),
        }

    def build_word_phonemizer(self) -> WordPhonemizer:
        wp = WordPhonemizer(self.tokenizer)
        tables = self.export_tables()
        for k, p in zip(tables["phonemizer.rules.keys"],
                        tables["phonemizer.rules.phonemes"]):
            wp.add_rule(k.split("."), p)
        return wp

    def build_phonemizer(self) -> Phonemizer:
        d = PhonemeDictionary()
        for w, p in self.exceptions.items():
            d.add(w, p)
        return Phonemizer(d, self.build_word_phonemizer())

    def export_gguf(self, path: str):
        from tts_tpu_torch.core.gguf import GGUFWriter

        w = GGUFWriter(path)
        w.add_kv("general.architecture", "phonemizer")
        for k, v in self.export_tables().items():
            w.add_kv(k, v)
        w.write()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="phonemizer-trainer",
        description="Train grapheme->IPA rules from a lexicon JSON "
                    '({"word": "ipa", ...}) and export a phonemizer GGUF.')
    p.add_argument("--lexicon", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--iterations", type=int, default=3)
    args = p.parse_args(argv)
    with open(args.lexicon) as f:
        lexicon = json.load(f)
    trainer = PhonemizerTrainer()
    stats = trainer.train(lexicon, iterations=args.iterations)
    trainer.export_gguf(args.out)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
