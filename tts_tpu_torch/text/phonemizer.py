"""Rule-based English text→IPA phonemizer (host-side), plus optional espeak-ng.

The port's own copy of `tts_tpu/text/phonemizer.py`, held to it by
`tests/test_torch_host.py`.

Re-implements the behavior of the reference's router-lexer phonemizer
(src/models/kokoro/phonemizer.{h,cpp}): a cursor walks the
text and routes each chunk to handlers for spaces, numbers (incl. thousand/
decimal separators up to 10^15), words (dictionary → roman numerals →
acronyms → trained grapheme rules), contractions, possessives, symbol
replacements, and punctuation.

Deviations from the reference, where its code is demonstrably buggy, are
marked with "NOTE(parity)" comments:
  * corpus::last() (phonemizer.cpp:289-303) returns the previous character
    minus its final byte (empty for ASCII); we return the actual previous
    character so possessives produce s/z/ᵻz as intended.
  * build_subthousand_phoneme (phonemizer.cpp:447-461) omits spaces after
    "hundred"; we insert them (espeak, the training source, has them).
  * is_acronym_like's after_until check (phonemizer.cpp:714) compares spaces;
    we implement the evident intent: a 4+ letter all-caps word is an acronym
    unless its neighborhood is also all-caps.

Kokoro consumes the output through its char-level tokenizer; the phonemizer
itself is pure Python, pure function, trivially testable.
"""

from __future__ import annotations

from tts_tpu_torch.text import phoneme_data as D
from tts_tpu_torch.text.tokenizers import SinglePassTokenizer


def _lower(s: str) -> str:
    # ASCII-only lowering to mirror C tolower over bytes
    return "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in s)


def _is_upper_word(s: str) -> bool:
    return len(s) > 0 and all("A" <= c <= "Z" for c in s)


def _upper_count(s: str) -> int:
    return sum(1 for c in s if "A" <= c <= "Z")


def replace_accents(word: str) -> str:
    return "".join(D.ACCENT_FOLD.get(c, c) for c in word)


# ---------------------------------------------------------------------------
# Number verbalization
# ---------------------------------------------------------------------------

def build_subthousand_phoneme(value: int) -> str:
    parts = []
    hundreds = value // 100
    if hundreds > 0:
        parts.append(D.NUMBER_PHONEMES[hundreds] + " " + D.HUNDRED_PHONEME)
    value %= 100
    if 0 < value < 20:
        parts.append(D.NUMBER_PHONEMES[value])
    elif value > 0:
        tens = D.SUB_HUNDRED_NUMBERS[value // 10 - 2]
        ones = value % 10
        parts.append(tens + (" " + D.NUMBER_PHONEMES[ones] if ones else ""))
    return " ".join(parts)


def build_number_phoneme(value: int) -> str:
    """Verbalize an integer < 10^15 into IPA, comma-separated at group breaks
    (parity: phonemizer.cpp:463-523)."""
    groups = [(D.TRILLION, D.TRILLION_PHONEME), (D.BILLION, D.BILLION_PHONEME),
              (D.MILLION, D.MILLION_PHONEME), (1000, D.THOUSAND_PHONEME)]
    out = []
    remainder = value
    for base, name in groups:
        if remainder > base:
            n, remainder = divmod(remainder, base)
            out.append(build_subthousand_phoneme(n) + " " + name)
    if remainder > 0 or not out:
        out.append(build_subthousand_phoneme(remainder) if remainder > 0
                   else D.NUMBER_PHONEMES[0])
    return ", ".join(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# Cursor over the text (character-based; the reference walks utf-8 bytes)
# ---------------------------------------------------------------------------

class Corpus:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def next(self, count: int = 1) -> str:
        return self.text[self.pos : self.pos + count]

    def last(self, count: int = 1) -> str:
        # NOTE(parity): reference's corpus::last drops the final byte; we
        # return the true preceding characters.
        start = max(0, self.pos - count)
        return self.text[start : self.pos]

    def after(self, offset: int, count: int = 1) -> str:
        p = self.pos + offset
        return self.text[p : p + count]

    def pop(self, count: int = 1) -> str:
        s = self.next(count)
        self.pos += len(s)
        return s

    def pop_str(self, s: str):
        """Advance past a chunk previously peeked (replaces size_pop)."""
        self.pos += len(s)

    def run_in(self, charset: str, start_offset: int = 0) -> str:
        """Maximal run of chars from `charset` starting at pos+start_offset."""
        p = self.pos + start_offset
        end = p
        while end < len(self.text) and self.text[end] in charset:
            end += 1
        return self.text[p:end]

    def next_in(self, charset: str) -> tuple[str, bool]:
        run = self.run_in(charset)
        has_accent = any(c in D.COMMON_ACCENTED_CHARACTERS for c in run)
        return run, has_accent

    def pop_in(self, charset: str) -> str:
        run = self.run_in(charset)
        self.pos += len(run)
        return run


# ---------------------------------------------------------------------------
# Trained grapheme rules (word_phonemizer) and exception dictionary
# ---------------------------------------------------------------------------

class RuleNode:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: dict[str, RuleNode] = {}
        self.value = ""

    def lookup(self, keys: list[str], index: int) -> str:
        if index >= len(keys):
            return self.value
        key = keys[index]
        child = self.children.get(key)
        if child is None:
            # wildcard rules: '*xyz' suffix match, 'xyz*' prefix match
            for pat, node in self.children.items():
                if pat.startswith("*") and key.endswith(pat[1:]):
                    child = node
                    break
                if pat.endswith("*") and pat != "*" and key.startswith(pat[:-1]):
                    child = node
                    break
        return child.lookup(keys, index + 1) if child is not None else self.value


class WordPhonemizer:
    """Grapheme→phoneme via trained contextual rules keyed on
    (grapheme, prev, next, word) with wildcard fallbacks
    (parity: phonemizer.cpp:373-445)."""

    def __init__(self, tokenizer: SinglePassTokenizer):
        self.tokenizer = tokenizer
        self.rules: dict[str, RuleNode] = {}

    def add_rule(self, keys: list[str], phoneme: str):
        node = self.rules.setdefault(keys[0], RuleNode())
        for key in keys[1:]:
            node = node.children.setdefault(key, RuleNode())
        node.value = phoneme

    def phonemize(self, word: str) -> str:
        word = _lower(word)
        graphemes = self.tokenizer.token_split(word)
        out = []
        for i, g in enumerate(graphemes):
            before = graphemes[i - 1] if i > 0 else "^"
            after = graphemes[i + 1] if i + 1 < len(graphemes) else "$"
            node = self.rules.get(g)
            if node is not None:
                out.append(node.lookup([before, after, word], 0))
        return "".join(out)

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "WordPhonemizer":
        tok_key = "phonemizer.graphemes" if "phonemizer.graphemes" in kv else "tokenizer.ggml.tokens"
        wp = cls(SinglePassTokenizer(list(kv[tok_key])))
        keys = kv["phonemizer.rules.keys"]
        phonemes = kv["phonemizer.rules.phonemes"]
        for k, p in zip(keys, phonemes):
            wp.add_rule(k.split("."), p)
        return wp


class DictResponse:
    __slots__ = ("value", "after_match", "needs_number_before",
                 "not_at_clause_end", "not_at_clause_start", "partial")

    def __init__(self, value: str, key_flags: str = "", after_match: str = ""):
        self.value = value
        self.after_match = after_match
        self.partial = bool(after_match)
        self.needs_number_before = key_flags.startswith("$")
        self.not_at_clause_start = key_flags.startswith("#")
        self.not_at_clause_end = key_flags.endswith("#")

    def is_match(self, text: Corpus, flags: "Conditions", word: str = "") -> bool:
        # NOTE(parity): the reference compares after_match at the word *start*
        # (phonemizer.cpp:537), which can never match the trainer's
        # "rest-of-compound" values; we compare at the word end as intended.
        if self.not_at_clause_end:
            chunk = text.run_in(D.NON_CLAUSE_WORD_CHARACTERS)
            nxt = text.after(len(chunk))
            if nxt in ("!", ".", "?"):
                return False
        if self.partial and text.after(len(word), len(self.after_match)) != self.after_match:
            return False
        if self.needs_number_before and not flags.was_number:
            return False
        if self.not_at_clause_start and flags.beginning_of_clause:
            return False
        return True


class PhonemeDictionary:
    """Word→IPA exceptions with per-entry match conditions
    (parity: phonemizer.cpp:540-551, 1068-1116)."""

    def __init__(self):
        self.lookup_map: dict[str, list[DictResponse]] = {}

    def add(self, key: str, values: str):
        flags = key
        clean = key
        if clean[:1] in "$#":
            clean = clean[1:]
        if clean.endswith("#"):
            clean = clean[:-1]
        out = []
        for val in values.split(","):
            parts = val.split(":")
            if len(parts) > 1:
                out.append(DictResponse(parts[0], flags, after_match=parts[1]))
            else:
                out.append(DictResponse(val, flags))
        self.lookup_map[clean] = out

    def lookup(self, text: Corpus, word: str, flags: "Conditions") -> DictResponse | None:
        """None = not in dictionary; DictResponse with value=None means the
        dictionary vetoes all candidates → phonetic fallback."""
        candidates = self.lookup_map.get(word)
        if candidates is None:
            return None
        for cand in candidates:
            if not cand.partial and not (cand.needs_number_before or cand.not_at_clause_end
                                         or cand.not_at_clause_start):
                return cand
            if cand.is_match(text, flags, word):
                return cand
        return DictResponse("")  # phonetic fallback marker

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "PhonemeDictionary":
        d = cls()
        for key, values in zip(kv["phonemizer.dictionary.keys"],
                               kv["phonemizer.dictionary.values"]):
            d.add(key, values)
        return d


class Conditions:
    """Lexer state flags (parity: phonemizer.cpp:250-271)."""

    def __init__(self):
        self.hyphenated = False
        self.was_all_capitalized = False
        self.was_word = False
        self.was_punctuated_acronym = False
        self.was_number = False
        self.beginning_of_clause = True

    def reset_for_clause_end(self):
        self.hyphenated = False
        self.was_punctuated_acronym = False
        self.beginning_of_clause = True
        self.was_number = False

    def reset_for_space(self):
        self.hyphenated = False
        self.was_punctuated_acronym = False
        self.was_word = False

    def update_for_word(self, word: str, allow_upper_check: bool = True):
        if allow_upper_check and not _is_upper_word(word):
            self.was_all_capitalized = False
        self.was_word = True
        self.beginning_of_clause = False
        self.hyphenated = False
        self.was_number = False


# ---------------------------------------------------------------------------
# The router-lexer
# ---------------------------------------------------------------------------

class Phonemizer:
    """text → IPA phoneme string.  `mode` is "tts" (rules) or "espeak"."""

    def __init__(self, dictionary: PhonemeDictionary | None,
                 word_phonemizer: WordPhonemizer | None,
                 mode: str = "tts", preserve_punctuation: bool = True,
                 espeak_voice: str = "gmw/en-US"):
        self.dict = dictionary or PhonemeDictionary()
        self.word_phonemizer = word_phonemizer
        self.mode = mode
        self.preserve_punctuation = preserve_punctuation
        self.espeak_voice = espeak_voice

    # -- public API ---------------------------------------------------------
    def text_to_phonemes(self, text: str) -> str:
        if self.mode == "espeak":
            from tts_tpu_torch.text.espeak import espeak_text_to_phonemes
            return espeak_text_to_phonemes(text, self.espeak_voice,
                                           self.preserve_punctuation)
        corpus = Corpus(text)
        flags = Conditions()
        out: list[str] = []
        while self._route(corpus, out, flags):
            pass
        return "".join(out)

    __call__ = text_to_phonemes

    @classmethod
    def from_gguf_kv(cls, kv: dict, espeak_voice: str = "gmw/en-US") -> "Phonemizer":
        ph_type = int(kv.get("phonemizer.type", 0))
        if ph_type == 1:  # ESPEAK
            return cls(None, None, mode="espeak", espeak_voice=espeak_voice)
        return cls(PhonemeDictionary.from_gguf_kv(kv), WordPhonemizer.from_gguf_kv(kv))

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _sep(out: list[str], flags: Conditions):
        if flags.was_word and out and not out[-1].endswith(" ") and not flags.hyphenated:
            out.append(" ")

    # -- routing -------------------------------------------------------------
    def _route(self, text: Corpus, out: list[str], flags: Conditions) -> bool:
        nxt = text.next()
        if nxt == "":
            return False
        if nxt in D.SPACE_CHARACTERS:
            return self._handle_space(text, out, flags)
        if nxt.isascii() and nxt.isdigit():
            return self._handle_numeric(text, out, flags)
        if nxt in D.ALPHABET:
            return self._handle_word(text, out, flags)
        return self._handle_punctuation(text, nxt, out, flags)

    def _handle_space(self, text: Corpus, out: list[str], flags: Conditions) -> bool:
        flags.reset_for_space()
        text.pop_in(" \n\f\t")
        if not out or not out[-1].endswith(" "):
            out.append(" ")
        return True

    # -- numbers -------------------------------------------------------------
    def _append_numeric_series(self, series: str, out: list[str], flags: Conditions):
        if series and flags.was_word and out and not out[-1].endswith(" ") and not flags.hyphenated:
            out.append(" ")
        out.append(" ".join(D.NUMBER_PHONEMES[int(c)] for c in series))
        if series:
            flags.update_for_word(series)
            flags.was_number = True

    def _handle_numeric_series(self, text: Corpus, out: list[str], flags: Conditions) -> bool:
        series = text.pop_in(D.NUMBER_CHARACTERS)
        self._append_numeric_series(series, out, flags)
        return True

    def _handle_numeric(self, text: Corpus, out: list[str], flags: Conditions) -> bool:
        """Parse arabic numerals with ' '/','/'.' group separators and ','/'.'
        decimals (parity: phonemizer.cpp:585-696)."""
        number = text.run_in(D.COMPATIBLE_NUMERICS).strip(",. ")

        group_sep = ""
        decimal_sep = ""
        last_break = ""
        invalid = False
        count_since_break = 0
        built = ""
        for c in number:
            if c.isdigit():
                built += c
                count_since_break += 1
            elif last_break == "":
                if count_since_break > 3:
                    decimal_sep = c
                last_break = c
                built += c
                count_since_break = 0
            elif c != last_break:
                if c == " ":
                    break
                elif count_since_break == 3 and decimal_sep == "":
                    if group_sep == "":
                        group_sep = last_break
                    decimal_sep = c
                    built += c
                    count_since_break = 0
                    last_break = c
                elif count_since_break != 3:
                    if group_sep != "":
                        invalid = True
                    break
                else:
                    break
            else:  # c == last_break
                if decimal_sep != "":
                    break
                elif count_since_break != 3:
                    invalid = True
                    break
                else:
                    group_sep = c
                    built += c
                    count_since_break = 0

        if not invalid:
            if group_sep != "" and decimal_sep == "" and count_since_break != 3:
                invalid = True
            elif count_since_break == 3 and last_break != "" and decimal_sep == "" and group_sep == "":
                group_sep = last_break
            elif count_since_break != 3 and last_break != "" and decimal_sep == "" and group_sep == "":
                decimal_sep = last_break

        if invalid:
            return self._handle_numeric_series(text, out, flags)

        cleaned = built
        if group_sep:
            cleaned = cleaned.replace(group_sep, "")
        int_part = cleaned.split(decimal_sep)[0] if decimal_sep else cleaned
        value = int(int_part) if int_part else 0

        if value >= D.LARGEST_PRONOUNCABLE_NUMBER:
            return self._handle_numeric_series(text, out, flags)

        text.pop_str(built)

        phon = build_number_phoneme(value)
        if phon:
            self._sep(out, flags)
            out.append(phon)
            flags.update_for_word(built)
            flags.was_number = True
        if decimal_sep:
            parts = cleaned.split(decimal_sep)
            if len(parts) > 1 and parts[1]:
                out.append(" " + D.POINT_PHONEME + " ")
                self._append_numeric_series(parts[1], out, flags)
        return True

    # -- words ----------------------------------------------------------------
    def _handle_word(self, text: Corpus, out: list[str], flags: Conditions) -> bool:
        word, has_accent = text.next_in(D.WORD_CHARACTERS)
        word = word.rstrip(".")
        return self._process_word(text, out, word, flags, has_accent)

    def _process_word(self, text: Corpus, out: list[str], word: str,
                      flags: Conditions, has_accent: bool = False) -> bool:
        popped_extra = 0
        response = self.dict.lookup(text, word, flags)
        if has_accent and response is None:
            unaccented = replace_accents(word)
            popped_extra = len(word) - len(unaccented)
            word = unaccented
            response = self.dict.lookup(text, word, flags)

        if response is not None and response.value:
            self._sep(out, flags)
            flags.update_for_word(word)
            out.append(response.value)
            text.pop_str(word + response.after_match)
            text.pos += popped_extra
            return True
        if (response is None and _is_upper_word(word)
                and all(c in D.ROMAN_NUMERAL_CHARACTERS for c in word)
                and _lower(word) not in D.SMALL_ENGLISH_WORDS
                and self._handle_roman_numeral(text, out, flags)):
            return True
        if self._is_acronym_like(text, word, flags):
            return self._handle_acronym(text, word, out, flags)
        if "." in word:
            part, part_accent = text.next_in(D.ALPHABET + D.COMMON_ACCENTED_CHARACTERS)
            self._process_word(text, out, part, flags, part_accent)
            self._handle_punctuation(text, ".", out, flags)
            out.append(" ")
            flags.reset_for_space()
            return True
        return self._handle_phonetic(text, word, out, flags, popped_extra)

    def _handle_phonetic(self, text: Corpus, word: str, out: list[str],
                         flags: Conditions, popped_extra: int = 0) -> bool:
        self._sep(out, flags)
        if self.word_phonemizer is not None:
            out.append(self.word_phonemizer.phonemize(word))
        else:
            out.append(word)
        text.pop_str(word)
        text.pos += popped_extra
        flags.update_for_word(word)
        return True

    def _is_acronym_like(self, text: Corpus, word: str, flags: Conditions) -> bool:
        if "." in word:
            for part in word.split("."):
                if len(part) == 0:
                    return False
                if len(part) > 1:
                    if len(part) > 2 or not (part[0].isupper() and part[1].islower()):
                        return False
            return True
        if len(word) < 4:
            return _lower(word) not in D.SMALL_ENGLISH_WORDS
        if _is_upper_word(word):
            # NOTE(parity): intent of phonemizer.cpp:713-718 — treat as part of
            # an all-caps span (not an acronym) if the previous or next word is
            # also all-caps.
            next_word = text.run_in(D.ALPHABET, start_offset=len(word) + 1)
            if flags.was_all_capitalized or (next_word and _is_upper_word(next_word)):
                flags.was_all_capitalized = True
                return False
            return True
        if _upper_count(word) > len(word) // 2:
            return True
        return False

    def _handle_acronym(self, text: Corpus, word: str, out: list[str],
                        flags: Conditions) -> bool:
        spelled = []
        for c in word:
            if c == ".":
                flags.was_punctuated_acronym = True
                continue
            ph = D.LETTER_PHONEMES.get(c.lower() if c.isascii() else c)
            if ph:
                spelled.append(ph)
        text.pop_str(word)
        self._sep(out, flags)
        out.append("".join(spelled))
        flags.update_for_word(word, allow_upper_check=False)
        return True

    def _handle_roman_numeral(self, text: Corpus, out: list[str],
                              flags: Conditions) -> bool:
        total = 0
        last_value = 0
        running = ""
        nxt = text.next()
        while nxt and nxt in D.ROMAN_NUMERAL_CHARACTERS:
            found = False
            for size in range(4, 0, -1):
                chunk = _lower(text.after(len(running), size))
                value = D.ROMAN_NUMERALS.get(chunk)
                if value is not None:
                    if total == 0 or last_value > value:
                        found = True
                        total += value
                        last_value = value
                        running += chunk
                    else:
                        return False
            if not found:
                return False
            nxt = text.after(len(running))
        if total == 0:
            return False
        self._sep(out, flags)
        out.append(build_number_phoneme(total))
        text.pop_str(running)
        flags.update_for_word(running, allow_upper_check=False)
        flags.was_number = True
        return True

    # -- punctuation / possessives / contractions ------------------------------
    def _handle_possession_plural(self, text: Corpus, out: list[str],
                                  flags: Conditions) -> bool:
        if text.next(2) == "'s":
            last = _lower(replace_accents(text.last()))
            if last and last in D.VOWELS:
                out.append("z")
            elif last in ("s", "z"):
                out.append("ᵻz")
            elif last and last in D.ALPHABET:
                out.append("s")
            else:
                out.append("ˈɛs")
            text.pop(2)
        else:
            text.pop()
        return True

    def _handle_contraction(self, text: Corpus, out: list[str],
                            flags: Conditions) -> bool:
        text.pop()  # the apostrophe
        nxt = _lower(text.run_in(D.ALPHABET))
        phoneme = D.CONTRACTION_PHONEMES.get(nxt)
        if phoneme is None:
            return True
        out.append(phoneme)
        text.pop_in(D.ALPHABET)
        return True

    def _handle_replacement(self, text: Corpus, nxt: str, out: list[str],
                            flags: Conditions) -> bool:
        self._sep(out, flags)
        out.append(D.REPLACEABLE[nxt])
        flags.update_for_word(nxt)
        text.pop()
        return True

    def _handle_punctuation(self, text: Corpus, nxt: str, out: list[str],
                            flags: Conditions) -> bool:
        last = text.last()
        after = text.after(1)
        if nxt.startswith("."):
            if flags.was_punctuated_acronym:
                flags.was_punctuated_acronym = False
                out.append(nxt)
                text.pop()
                if text.after(1, 2) == "'s":
                    return self._handle_possession_plural(text, out, flags)
                return True
            chunk = text.run_in(".")
            out.append(chunk)
            text.pop_str(chunk)
            return True
        if nxt == "'":
            if flags.was_word and (after == "s" or not (after and after in D.ALPHABET)):
                return self._handle_possession_plural(text, out, flags)
            if flags.was_word and (after in D.CONTRACTION_PHONEMES
                                   or text.after(1, 2) in D.CONTRACTION_PHONEMES):
                return self._handle_contraction(text, out, flags)
            text.pop()
            return True
        if nxt.startswith("-"):
            if last == " " and after == " ":
                text.pop(2)
                flags.reset_for_space()
                return True
            if after == "-":
                text.pop(2)
                out.append(" ")
                flags.reset_for_space()
                return True
            if not flags.beginning_of_clause and flags.was_word and after and after in D.ALPHABET:
                flags.hyphenated = True
                text.pop()
                return True
            text.pop()
            return True
        if nxt in D.CLAUSE_BREAKS:
            out.append(nxt)
            flags.reset_for_clause_end()
            text.pop()
            return True
        if nxt in D.NOOP_BREAKS:
            out.append(nxt)
            text.pop()
            return True
        if nxt in D.REPLACEABLE:
            return self._handle_replacement(text, nxt, out, flags)
        text.pop()
        return True
