"""Host-side tokenizers: Kokoro's greedy single-pass tokenizer and Orpheus's
byte-pair encoder (llama-3 vocabulary).

The port's own copies of `SinglePassTokenizer` and `BPETokenizer` from
`tts_tpu/text/tokenizers.py`, so both packages give the same ids for the
same text:
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
