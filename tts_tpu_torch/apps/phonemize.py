"""phonemize on the port: run the phonemizer standalone (parity: the
reference's examples/phonemize).

The port's own copy of `tts_tpu/apps/phonemize.py`, through the port's
`text/phonemizer.py`: the same flags, output and return codes.  Espeak
mode needs libespeak-ng; without it the command exits 1 with the
phonemizer's missing-library error.

Usage:
  python -m tts_tpu_torch.apps.phonemize --phonemizer-path rules.gguf --prompt "text"
  python -m tts_tpu_torch.apps.phonemize --use-espeak --prompt "text"
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="phonemize", description=__doc__)
    p.add_argument("--phonemizer-path", "-mp", default="",
                   help="GGUF file with phonemizer rules (a Kokoro model GGUF works)")
    p.add_argument("--prompt", "-p", required=True)
    p.add_argument("--use-espeak", "-ue", action="store_true")
    p.add_argument("--espeak-voice-id", "-eid", default="gmw/en-US")
    args = p.parse_args(argv)

    from tts_tpu_torch.runtime.api import TTSError
    from tts_tpu_torch.text.phonemizer import Phonemizer

    try:
        if args.use_espeak:
            ph = Phonemizer(None, None, mode="espeak",
                            espeak_voice=args.espeak_voice_id)
        else:
            if not args.phonemizer_path:
                print("either --phonemizer-path or --use-espeak is required",
                      file=sys.stderr)
                return 1
            from tts_tpu_torch.core.gguf import GGUFFile
            with GGUFFile(args.phonemizer_path) as f:
                ph = Phonemizer.from_gguf_kv(f.kv)
        print(ph.text_to_phonemes(args.prompt))
        return 0
    except TTSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
