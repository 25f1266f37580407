"""Host-side tokenizers: Parler's SentencePiece-unigram tokenizer, Kokoro's
greedy single-pass tokenizer and Orpheus's byte-pair encoder (llama-3
vocabulary).

The port's own copies of `UnigramTokenizer`, `SinglePassTokenizer` and
`BPETokenizer` from `tts_tpu/text/tokenizers.py`, so both packages give the
same ids for the same text:
- `UnigramTokenizer` is a Viterbi best path over the vocabulary's byte
  strings, with an unknown-token fallback and consecutive unknowns merged
  (Parler and its T5 encoder; the GGUF vocabulary stores literal spaces);
- `SinglePassTokenizer.tokenize` is shortest-match-first over bytes (Kokoro's
  char-level vocabulary), `token_split` longest-match (the phonemizer's
  graphemes);
- `BPETokenizer` is rank-based byte-pair merging with the 'Ġ' space marker,
  leftmost-lowest-rank merge order.
Pure host-side string work; the ids then go to the device.
"""

from __future__ import annotations

import re
from typing import Sequence

_DUPED_SPACES = re.compile(r"\s{2,}")


class UnigramTokenizer:
    def __init__(self, vocab: dict[str, int], unk_token: int, scores: Sequence[float],
                 eos_token: int = 1, dedupe_spaces: bool = True):
        self.vocab = vocab
        self.scores = list(scores)
        self.unk_token = int(unk_token)
        self.unk_score = self.scores[self.unk_token] if self.scores else 0.0
        self.eos_token = int(eos_token)
        self.dedupe_spaces = dedupe_spaces
        # byte-keyed vocab, as the reference's byte trie matches
        self._bvocab: dict[bytes, int] = {k.encode("utf-8"): v for k, v in vocab.items()}
        self._max_len = max((len(k) for k in self._bvocab), default=1)

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "UnigramTokenizer":
        tokens = [t.replace("\u2581", " ") for t in kv["tokenizer.ggml.tokens"]]
        vocab = {t: i for i, t in enumerate(tokens)}
        scores = [float(s) for s in kv["tokenizer.ggml.scores"]]
        unk = int(kv["tokenizer.ggml.unknown_token_id"])
        eos = int(kv.get("tokenizer.ggml.eos_token_id", 1))
        return cls(vocab, unk, scores, eos_token=eos)

    def tokenize(self, text: str) -> list[int]:
        if self.dedupe_spaces:
            text = " " + _DUPED_SPACES.sub(" ", text)
        data = text.encode("utf-8")
        n = len(data)
        NEG = float("-inf")
        # best[i] = (token, backpointer offset, best score reaching byte i)
        best = [(self.unk_token, 0, NEG)] * (n + 1)
        best[0] = (self.unk_token, 0, 0.0)

        offset = 0
        while offset < n:
            b0 = data[offset]
            step = 1 if b0 < 0xC0 else (2 if b0 < 0xE0 else (3 if b0 < 0xF0 else 4))
            step = min(step, n - offset)
            base_score = best[offset][2]
            found_known_char = False
            end_cap = min(n, offset + self._max_len)
            for end in range(offset + 1, end_cap + 1):
                tok_id = self._bvocab.get(data[offset:end])
                if tok_id is None:
                    continue
                if end - offset == step:
                    found_known_char = True
                score = base_score + self.scores[tok_id]
                if score > best[end][2]:
                    best[end] = (tok_id, offset, score)
            if not found_known_char:
                end = offset + step
                score = base_score + self.unk_score
                if score > best[end][2]:
                    best[end] = (self.unk_token, offset, score)
            offset += step

        # walk back, merging consecutive unknowns
        tokens: list[int] = []
        pos = n
        prev_unknown = False
        while True:
            tok, back, _ = best[pos]
            is_unknown = tok == self.unk_token
            if not (prev_unknown and is_unknown):
                tokens.append(tok)
            if back == 0:
                break
            prev_unknown = is_unknown
            pos = back
        tokens.reverse()
        return tokens


class SinglePassTokenizer:
    """Vocabulary-listed greedy tokenizer; ids are list positions."""

    def __init__(self, tokens: Sequence[str], unknown_id: int = 0):
        self.tokens = list(tokens)
        self.unknown_id = unknown_id
        self._ids = {}
        for i, t in enumerate(self.tokens):
            self._ids.setdefault(t, i)   # std::find -> first occurrence wins
        self._vocab = set(self.tokens)
        self._max_size = max((len(t.encode("utf-8")) for t in self.tokens), default=0)

    @classmethod
    def from_gguf_kv(cls, kv: dict, key: str = "phonemizer.graphemes") -> "SinglePassTokenizer":
        return cls(list(kv[key]))

    def tokenize(self, text: str) -> list[int]:
        """Shortest-match-first over bytes (parity: tokenizer.cpp:159-177)."""
        data = text.encode("utf-8")
        ids: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            tok_id = self.unknown_id
            for size in range(1, min(n - pos, self._max_size) + 1):
                part = data[pos : pos + size]
                try:
                    cand = self._ids.get(part.decode("utf-8"))
                except UnicodeDecodeError:
                    cand = None
                if cand is not None:
                    tok_id = cand
                    pos += size
                    break
            else:
                pos += 1
            ids.append(tok_id)
        return ids

    def token_split(self, text: str) -> list[str]:
        """Longest-match split into known grams (parity: tokenizer.cpp:179-194).
        Unknown leading characters come through as single-char tokens."""
        out: list[str] = []
        pos = 0
        while pos < len(text):
            token = text[pos : pos + 1]
            end = pos + 2
            while end <= len(text) and text[pos:end] in self._vocab:
                token = text[pos:end]
                end += 1
            out.append(token)
            pos += len(token)
        return out


class BPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: dict[tuple[str, str], int],
                 bos_token_id: int, eos_token_id: int):
        self.vocab = vocab
        self.merges = merges
        self.bos_token_id = int(bos_token_id)
        self.eos_token_id = int(eos_token_id)

    @classmethod
    def from_gguf_kv(cls, kv: dict, base: str = "tokenizer.ggml") -> "BPETokenizer":
        vocab = {t: i for i, t in enumerate(kv[f"{base}.tokens"])}
        merges = {}
        for i, raw in enumerate(kv[f"{base}.merges"]):
            a, b = raw.split(" ")
            merges[(a, b)] = i
        return cls(vocab, merges, kv[f"{base}.bos_token_id"], kv[f"{base}.eos_token_id"])

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        space_prior = False
        for chunk in re.split(r"( )", text):
            if chunk == " ":
                space_prior = True
            elif chunk:
                self._bpe(("Ġ" + chunk) if space_prior else chunk, ids)
                space_prior = False
        return ids

    def _bpe(self, word: str, out: list[int]):
        if word in self.vocab:
            out.append(self.vocab[word])
            return
        parts = list(word)
        while len(parts) > 1:
            ranked = [
                (self.merges[(parts[i], parts[i + 1])], i)
                for i in range(len(parts) - 1)
                if (parts[i], parts[i + 1]) in self.merges
            ]
            if not ranked:
                break
            _, i = min(ranked)
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2 :]
        for p in parts:
            out.append(self.vocab.get(p, 0))
