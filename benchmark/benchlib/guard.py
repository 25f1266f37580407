"""The import guard: no benchmark process may hold JAX or the JAX package.

A module counts by its top-level name (the part before the first dot),
compared whole, so `tts_tpu_torch` is not `tts_tpu`.  The references add
`tts_tpu_torch` to the list: they take nothing of the program."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tts_tpu")
PROGRAM = "tts_tpu_torch"


def found(extra: tuple = ()) -> list[str]:
    """Top-level names in sys.modules that are forbidden."""
    names = set(FORBIDDEN) | set(extra)
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & names)


def check(where: str, extra: tuple = ()) -> bool:
    """True if the process is clean; otherwise names what it holds on stderr."""
    bad = found(extra)
    if bad:
        print(f"import guard: {where} holds {', '.join(bad)}", file=sys.stderr)
    return not bad
