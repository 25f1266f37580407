"""In-process audio playback through SDL2 (ctypes), with graceful absence.

The port's own copy of `tts_tpu/runtime/playback.py`, held to it by
`tests/test_torch_apps.py`.

Parity: the reference queues the whole float32 buffer on an SDL audio device
and polls until the queue drains (examples/cli/playback.cpp:18-62).  This
binds the same five SDL calls via ctypes so no compiled extension is needed;
when libSDL2 is not installed `available()` is False and the CLI falls back
to shelling out to a system player.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

SDL_INIT_AUDIO = 0x00000010
AUDIO_F32 = 0x8120  # AUDIO_F32LSB


class SDL_AudioSpec(ctypes.Structure):
    _fields_ = [
        ("freq", ctypes.c_int),
        ("format", ctypes.c_uint16),
        ("channels", ctypes.c_uint8),
        ("silence", ctypes.c_uint8),
        ("samples", ctypes.c_uint16),
        ("padding", ctypes.c_uint16),
        ("size", ctypes.c_uint32),
        ("callback", ctypes.c_void_p),
        ("userdata", ctypes.c_void_p),
    ]


_lib = None


def _load():
    global _lib
    if _lib is None:
        path = ctypes.util.find_library("SDL2")
        if path is None:
            _lib = False
        else:
            try:
                lib = ctypes.CDLL(path)
                lib.SDL_OpenAudioDevice.restype = ctypes.c_uint32
                lib.SDL_GetQueuedAudioSize.restype = ctypes.c_uint32
                _lib = lib
            except OSError:
                _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def play(audio: np.ndarray, sample_rate: int, *, poll_ms: int = 100) -> bool:
    """Queue `audio` (float32 mono) and block until playback drains.
    Returns False (without raising) when SDL2 is unavailable or errors —
    the caller then falls back to a system player."""
    lib = _load()
    if not lib:
        return False
    data = np.ascontiguousarray(audio, dtype=np.float32)
    if lib.SDL_Init(SDL_INIT_AUDIO) != 0:
        return False
    try:
        spec = SDL_AudioSpec(freq=int(sample_rate), format=AUDIO_F32,
                             channels=1, silence=0, samples=4096, padding=0,
                             size=data.size, callback=None, userdata=None)
        dev = lib.SDL_OpenAudioDevice(None, 0, ctypes.byref(spec), None, 0)
        if not dev:
            return False
        lib.SDL_PauseAudioDevice(ctypes.c_uint32(dev), 0)
        if lib.SDL_QueueAudio(ctypes.c_uint32(dev),
                              data.ctypes.data_as(ctypes.c_void_p),
                              ctypes.c_uint32(data.nbytes)) != 0:
            lib.SDL_CloseAudioDevice(ctypes.c_uint32(dev))
            return False
        while lib.SDL_GetQueuedAudioSize(ctypes.c_uint32(dev)):
            lib.SDL_Delay(poll_ms)
        lib.SDL_CloseAudioDevice(ctypes.c_uint32(dev))
        return True
    finally:
        lib.SDL_Quit()
