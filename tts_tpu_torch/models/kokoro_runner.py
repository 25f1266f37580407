"""Kokoro runner: host-side control flow (phonemize -> tokenize -> chunk ->
synthesize -> concat).

Counterpart of `tts_tpu/models/kokoro_runner.py`, line for line but for the
device: the model lives on the runner's device, and `synthesize` runs each
chunk at its exact shapes.  Parity: kokoro_runner::generate /
tokenize_chunks (the reference's src/models/kokoro/model.cpp:1334-1459)."""

from __future__ import annotations

import re
import time

import numpy as np

from tts_tpu_torch.models.kokoro import KokoroModel
from tts_tpu_torch.models.registry import register_loader
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError, TTSResponse, TTSRunner
from tts_tpu_torch.text.phonemizer import Phonemizer
from tts_tpu_torch.text.tokenizers import SinglePassTokenizer

# Kokoro voice packs carry their language in the first letter of the voice
# name (kokoro/model.h:20-30).
KOKORO_LANG_TO_ESPEAK_ID = {
    "a": "gmw/en-US", "b": "gmw/en", "e": "roa/es", "f": "roa/fr",
    "h": "inc/hi", "i": "roa/it", "j": "jpx/ja", "p": "roa/pt-BR",
    "z": "sit/cmn",
}

DEFAULT_VOICE = "af_heart"


class KokoroRunner(TTSRunner):
    sample_rate = 24000
    architecture = "kokoro"

    def __init__(self, model: KokoroModel, tokenizer: SinglePassTokenizer,
                 phonemizer: Phonemizer, config: GenerationConfig):
        self.model = model
        self.tokenizer = tokenizer
        self.phonemizer = phonemizer
        self.default_voice = config.voice or DEFAULT_VOICE

    # -- host text handling --------------------------------------------------
    def tokenize_chunks(self, clauses: list[str]) -> list[list[int]]:
        """Split clause token streams into <=max_context windows at space
        boundaries (parity: model.cpp:1340-1388)."""
        cfg = self.model.cfg
        max_len = cfg.max_context_length
        chunks: list[list[int]] = []
        for clause in clauses:
            clause = clause.strip()
            if not clause:
                continue
            tokens = self.tokenizer.tokenize(clause)
            if len(tokens) + 2 <= max_len:
                chunks.append([cfg.bos_token_id] + tokens + [cfg.eos_token_id])
                continue
            start = 0
            last_space = 0
            for i, tok in enumerate(tokens):
                if tok == cfg.space_token_id:
                    last_space = i
                if i - start >= max_len - 2:
                    split = last_space if last_space > start else i
                    chunks.append([cfg.bos_token_id] + tokens[start:split]
                                  + [cfg.eos_token_id])
                    start = split
                    last_space = start
            if start < len(tokens):
                chunks.append([cfg.bos_token_id] + tokens[start:] + [cfg.eos_token_id])
        return chunks

    def list_voices(self) -> list[str]:
        return sorted(self.model.params["voices"])

    def _select_voice(self, config: GenerationConfig) -> str:
        """Resolve the voice and point the espeak phonemizer at the voice's
        language (first letter of the pack name, kokoro/model.h:20-30) —
        shared by generate() and generate_stream()."""
        voice = config.voice or self.default_voice
        if voice not in self.model.params["voices"]:
            raise TTSError(f"unknown Kokoro voice '{voice}' "
                           f"(available: {', '.join(self.list_voices())})")
        if self.phonemizer.mode == "espeak":
            self.phonemizer.espeak_voice = (
                config.espeak_voice_id
                or KOKORO_LANG_TO_ESPEAK_ID.get(voice[0], "gmw/en-US"))
        return voice

    # -- streaming ----------------------------------------------------------
    def generate_stream(self, text: str, config: GenerationConfig | None = None,
                        first_chunk_tokens: int = 10):
        """Yield audio chunks clause-by-clause for low time-to-first-audio.

        The reference decodes whole utterances; here each clause is
        synthesized as its own chunk.  The first emission is additionally
        sub-chunked to `first_chunk_tokens` (split at a space), so first
        audio comes from the shortest chunk."""
        config = config or GenerationConfig()
        voice = self._select_voice(config)
        cfg = self.model.cfg
        seed = config.seed if config.seed is not None else 0

        normalized = re.sub(r"[,;:]", "--", text).replace("\n", " ")
        phonemes = self.phonemizer.text_to_phonemes(normalized)
        clauses = [c for c in re.split(r"[.!?]", phonemes) if c.strip()]
        chunks = self.tokenize_chunks(clauses)
        if chunks and first_chunk_tokens and len(chunks[0]) > first_chunk_tokens + 4:
            head = chunks[0]
            body = head[1:-1]                       # strip bos/eos
            split = first_chunk_tokens
            for i in range(min(first_chunk_tokens, len(body) - 1), 0, -1):
                if body[i] == cfg.space_token_id:
                    split = i
                    break
            first = [cfg.bos_token_id] + body[:split] + [cfg.eos_token_id]
            rest = [cfg.bos_token_id] + body[split:] + [cfg.eos_token_id]
            chunks = [first, rest] + chunks[1:]
        for tokens in chunks:
            audio = self.model.synthesize(tokens, voice, seed=seed)
            if len(audio):
                yield audio

    # -- generation ----------------------------------------------------------
    def generate(self, text: str, config: GenerationConfig | None = None) -> TTSResponse:
        config = config or GenerationConfig()
        voice = self._select_voice(config)

        t0 = time.perf_counter()
        # ',;:' -> espeak-style pauses, newlines -> spaces (model.cpp:1415-1417;
        # the reference drops the first replacement by mistake — we apply both)
        normalized = re.sub(r"[,;:]", "--", text)
        normalized = normalized.replace("\n", " ")
        phonemes = self.phonemizer.text_to_phonemes(normalized)
        t1 = time.perf_counter()

        cfg = self.model.cfg
        seed = config.seed if config.seed is not None else 0
        chunks = None
        if len(phonemes) < cfg.max_context_length - 2:
            stripped = re.sub(r"[.!?]", "", phonemes).strip()
            if not stripped:
                return TTSResponse(sample_rate=self.sample_rate)
            tokens = ([cfg.bos_token_id] + self.tokenizer.tokenize(stripped)
                      + [cfg.eos_token_id])
            # a phoneme outside the vocabulary tokenizes to one id per
            # byte, so a short string can still overrun the context: such
            # an input takes the chunked path (the JAX runner fails on it)
            if len(tokens) <= cfg.max_context_length:
                chunks = [tokens]
        if chunks is None:
            chunks = self.tokenize_chunks(re.split(r"[.!?]", phonemes))
        pieces = [self.model.synthesize(tokens, voice, seed=seed) for tokens in chunks]
        t2 = time.perf_counter()

        # single-chunk utterances skip the concatenate copy (~400 KB memcpy)
        audio = (pieces[0] if len(pieces) == 1
                 else np.concatenate(pieces) if pieces
                 else np.zeros(0, np.float32))
        return TTSResponse(
            audio=audio, sample_rate=self.sample_rate,
            timings={"phonemize_ms": (t1 - t0) * 1e3,
                     "synthesize_ms": (t2 - t1) * 1e3, "chunks": len(pieces)})


@register_loader("kokoro")
def load_kokoro_runner(gguf_file, config: GenerationConfig, device) -> KokoroRunner:
    model = KokoroModel.from_gguf(gguf_file, device)
    tokenizer = SinglePassTokenizer.from_gguf_kv(gguf_file.kv, key="tokenizer.ggml.tokens")
    phonemizer = Phonemizer.from_gguf_kv(gguf_file.kv,
                                         espeak_voice=config.espeak_voice_id or "gmw/en-US")
    return KokoroRunner(model, tokenizer, phonemizer, config)
