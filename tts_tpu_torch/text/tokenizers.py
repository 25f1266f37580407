"""Byte-pair-encoding tokenizer of Orpheus (llama-3 vocabulary).

The port's own copy of `BPETokenizer` from `tts_tpu/text/tokenizers.py`:
rank-based byte-pair merging with the 'Ġ' space marker, leftmost-lowest-rank
merge order, so both packages give the same ids for the same text.  Pure
host-side string work; the ids then go to the device.
"""

from __future__ import annotations

import re


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
