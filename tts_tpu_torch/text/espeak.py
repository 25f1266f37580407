"""Optional espeak-ng binding via ctypes (the reference's ESPEAK_INSTALL path,
src/models/kokoro/phonemizer.cpp:3-46, 992-1021).  The port's own copy of
`tts_tpu/text/espeak.py`.

espeak-ng keeps global state, so all calls are serialized behind a module
lock — the Python analog of the reference's espeak_wrapper mutex singleton
(phonemizer.h:293-323).  If the shared library is absent we raise a
recoverable TTSError instead of aborting.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

from tts_tpu_torch.runtime.api import TTSError
from tts_tpu_torch.text.phoneme_data import STOPPING_TOKENS

_lock = threading.Lock()
_lib = None
_initialized = False

ESPEAK_CHARS_UTF8 = 1
AUDIO_OUTPUT_SYNCHRONOUS = 2


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("espeak-ng", "espeak"):
        path = ctypes.util.find_library(name)
        if path:
            _lib = ctypes.CDLL(path)
            _lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
            _lib.espeak_TextToPhonemes.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int]
            return _lib
    raise TTSError(
        "espeak-ng is not installed; use the built-in TTS phonemizer "
        "(phonemizer.type=0) or install libespeak-ng")


def available() -> bool:
    try:
        _load()
        return True
    except TTSError:
        return False


class _EspeakVoice(ctypes.Structure):
    # espeak_VOICE (speak_lib.h): we only read name/identifier
    _fields_ = [("name", ctypes.c_char_p), ("languages", ctypes.c_char_p),
                ("identifier", ctypes.c_char_p), ("gender", ctypes.c_ubyte),
                ("age", ctypes.c_ubyte), ("variant", ctypes.c_ubyte),
                ("xx1", ctypes.c_ubyte), ("score", ctypes.c_int),
                ("spare", ctypes.c_void_p)]


def list_voice_inventory() -> list[tuple[str, str]]:
    """[(name, identifier), ...] from espeak_ListVoices (NULL spec — the
    reference passes no voice_spec because specs don't support partial codes;
    phonemizer.cpp:178-180)."""
    lib = _load()
    lib.espeak_ListVoices.restype = ctypes.POINTER(ctypes.POINTER(_EspeakVoice))
    voices = lib.espeak_ListVoices(None)
    out = []
    i = 0
    while voices[i]:
        v = voices[i].contents
        out.append(((v.name or b"").decode("utf-8", "replace"),
                    (v.identifier or b"").decode("utf-8", "replace")))
        i += 1
    return out


def parse_voice_code(voice_code: str, voices: list[tuple[str, str]]) -> str:
    """Fuzzy-match a user voice code against the espeak voice inventory and
    return the matched identifier (parity: phonemizer.cpp:163-248
    parse_voice_code).  `voices` is [(name, identifier), ...].

    Search mode is chosen from the code's shape: 2 chars = language code
    ("en"), 3 chars = language-family code ("gmw"), contains "/" = identifier
    prefix ("gmw/en-us"), contains "-"/"_" = locale code ("en-gb"); anything
    else falls through to a name-substring search.  Shorter identifiers win
    ties (more-generic locales preferred).  NOTE(parity): the reference's
    single-part-identifier branch falls through to an out-of-bounds
    identifier_parts[1] read when the identifier has no "/"; we implement the
    intent (match, then move to the next voice)."""
    vc = voice_code.lower()
    by_lc = len(vc) == 2
    by_lfc = not by_lc and len(vc) == 3
    by_id = not by_lfc and not by_lc and "/" in vc
    by_lcc = not by_id and not by_lfc and not by_lc and ("-" in vc or "_" in vc)
    if by_id or by_lcc:
        vc = vc.replace("_", "-")

    primary: tuple[str, str] | None = None
    secondary: tuple[str, str] | None = None

    def better(cur, cand):
        return cur is None or len(cur[1]) > len(cand[1])

    for name, identifier in voices:
        parts = identifier.split("/")
        if len(parts) == 1:
            if vc == parts[0] or vc == name:
                primary = (name, identifier)
            continue
        if by_lc:
            lang = parts[1]
            if lang == vc:
                primary = (name, identifier)
                break  # exact match
            if lang.startswith(vc):
                if better(primary, (name, identifier)):
                    primary = (name, identifier)
            else:
                sub = lang.split("-")
                # country codes are typically capitalized in espeak-ng
                if (len(sub) > 1 and sub[1].lower() == vc
                        and better(secondary, (name, identifier))):
                    secondary = (name, identifier)
        elif by_lfc:
            # prefer ISO 639-3 language-code prefix over family-code match
            if parts[1].startswith(vc):
                if better(primary, (name, identifier)):
                    primary = (name, identifier)
            elif parts[0] == vc and better(secondary, (name, identifier)):
                secondary = (name, identifier)
        elif by_id and identifier.lower().startswith(vc):
            if better(primary, (name, identifier)):
                primary = (name, identifier)
        elif by_lcc and parts[1].lower().startswith(vc):
            if better(primary, (name, identifier)):
                primary = (name, identifier)
        elif vc in name.lower():
            if better(primary, (name, identifier)):
                primary = (name, identifier)
    match = primary or secondary
    if match is None:
        raise TTSError(
            f"Failed to match espeak voice code '{voice_code}' to known "
            f"espeak voices.")
    return match[1]


def _set_voice(lib, voice: str):
    """SetVoiceByName, falling back to fuzzy inventory resolution (parity:
    phonemizer.cpp:250-260 update_voice)."""
    if lib.espeak_SetVoiceByName(voice.encode()) != 0:   # != EE_OK
        resolved = parse_voice_code(voice, list_voice_inventory())
        lib.espeak_SetVoiceByName(resolved.encode())


def _ensure_init(voice: str):
    global _initialized
    lib = _load()
    if not _initialized:
        lib.espeak_Initialize(AUDIO_OUTPUT_SYNCHRONOUS, 0, None, 0)
        _initialized = True
    _set_voice(lib, voice)


def espeak_text_to_phonemes(text: str, voice: str = "gmw/en-US",
                            preserve_punctuation: bool = True,
                            ipa: bool = True) -> str:
    """Phonemize clause-by-clause, reinserting the punctuation espeak drops
    (parity: phonemizer.cpp:1001-1013)."""
    import re

    with _lock:
        _ensure_init(voice)
        lib = _load()
        mode = 0x02 if ipa else 0x01
        parts = re.split(f"([{re.escape(STOPPING_TOKENS)}])", text)
        phonemes = []
        for i in range(0, len(parts), 2):
            chunk = parts[i]
            if chunk:
                buf = ctypes.c_char_p(chunk.encode("utf-8"))
                ptr = ctypes.cast(ctypes.pointer(buf), ctypes.POINTER(ctypes.c_void_p))
                out = []
                # espeak advances the cursor one clause per call; bound the
                # loop so a library failure that stops advancing the cursor
                # can't spin forever (one clause >= 1 byte, so len(chunk)
                # iterations always suffice)
                for _ in range(len(chunk) + 1):
                    if not ptr.contents.value:
                        break
                    prev = ptr.contents.value
                    resp = lib.espeak_TextToPhonemes(ptr, ESPEAK_CHARS_UTF8, mode)
                    if resp:
                        out.append(resp.decode("utf-8"))
                    if ptr.contents.value == prev and not resp:
                        raise TTSError(
                            "espeak_TextToPhonemes made no progress "
                            f"(stuck at byte offset in {chunk[:40]!r}...)")
                phonemes.append(" ".join(out).strip())
            if preserve_punctuation and i + 1 < len(parts):
                phonemes.append(parts[i + 1])
        return "".join(phonemes)
