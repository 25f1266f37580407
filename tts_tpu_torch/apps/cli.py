"""tts-cli on the port: text in, WAV out, with the runner on `--device`.

The port's own copy of `tts_tpu/apps/cli.py`: the same flags, defaults,
messages, printed lines and return codes, plus `--device` (default cuda,
as the port's server).  A CUDA device with no card exits 1 with the
registry's error; nothing falls back to the CPU.  Flag-surface parity with
the reference CLI (examples/cli/cli.cpp); --n-threads and --use-metal are
accepted-but-advisory (PyTorch owns threading and device placement).

Usage:
  python -m tts_tpu_torch.apps.cli --model-path model.gguf --prompt "hello" \\
      [--save-path out.wav] [--voice af_heart] [--temperature 1.0] [--device cuda] ...
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tts-cli", description=__doc__)
    p.add_argument("--model-path", "-mp", required=True,
                   help="local path of the GGUF model (or test:dummy)")
    p.add_argument("--prompt", "-p", required=True,
                   help="the text prompt to generate audio for")
    p.add_argument("--save-path", "-sp", default="tts_tpu.wav",
                   help="output .wav path (default tts_tpu.wav)")
    p.add_argument("--temperature", "-t", type=float, default=1.0)
    p.add_argument("--topk", "-tk", type=int, default=50)
    p.add_argument("--top-p", "-tp", type=float, default=1.0)
    p.add_argument("--repetition-penalty", "-r", type=float, default=1.0)
    p.add_argument("--n-threads", "-nt", type=int, default=0,
                   help="accepted for parity; PyTorch manages threading")
    p.add_argument("--use-metal", "-m", action="store_true",
                   help="accepted for parity; the device is --device's")
    p.add_argument("--no-cross-attn", "-ca", action="store_true")
    p.add_argument("--conditional-prompt", "-cp", default="")
    p.add_argument("--text-encoder-path", "-tep", default="")
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--espeak-voice-id", "-eid", default="")
    p.add_argument("--max-tokens", "-mt", type=int, default=0)
    p.add_argument("--vad", "-va", action="store_true",
                   help="trim trailing silence from the output")
    p.add_argument("--play", action="store_true", help="play instead of saving")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--list-voices", action="store_true",
                   help="print the model's voices and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runner (default: cuda)")
    return p


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = build_parser().parse_args(argv)

    if args.top_p > 1.0 or args.top_p <= 0.0:
        print(f"The '--top-p' value must be between 0.0 and 1.0; got {args.top_p:.6f}.",
              file=sys.stderr)
        return 1
    if args.conditional_prompt and not args.text_encoder_path:
        print("'--text-encoder-path' must be specified when '--conditional-prompt' "
              "is passed.", file=sys.stderr)
        return 1

    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig, TTSError
    from tts_tpu_torch.utils.audio import write_wav

    config = GenerationConfig(
        voice=args.voice, top_k=args.topk, temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        use_cross_attn=not args.no_cross_attn,
        espeak_voice_id=args.espeak_voice_id, max_tokens=args.max_tokens,
        top_p=args.top_p, seed=args.seed)

    try:
        runner = runner_from_file(args.model_path, config, device=args.device)
        if args.list_voices:
            for v in runner.list_voices():
                print(v)
            return 0
        if args.conditional_prompt:
            runner.update_conditional_prompt(args.text_encoder_path,
                                             args.conditional_prompt)
        resp = runner.generate(args.prompt, config)
    except TTSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if len(resp.audio) == 0:
        print(f"Got empty response for prompt, '{args.prompt}'.", file=sys.stderr)
        return 1

    audio = resp.audio
    if args.vad:
        from tts_tpu_torch.runtime.vad import trim_silence
        audio = trim_silence(audio, resp.sample_rate)

    if args.play:
        # in-process SDL2 queue-audio first (playback.cpp:18-62), then a
        # system player, then fall through to saving
        from tts_tpu_torch.runtime import playback

        if playback.play(audio, resp.sample_rate):
            print(f"total time = {(time.perf_counter() - t_start) * 1e3:.2f} ms")
            return 0
        player = shutil.which("aplay") or shutil.which("play") or shutil.which("afplay")
        if not player:
            print("no audio output (SDL2/aplay/play/afplay); saving instead",
                  file=sys.stderr)
        else:
            with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                write_wav(tmp.name, audio, resp.sample_rate)
                subprocess.run([player, tmp.name], check=False)
            print(f"total time = {(time.perf_counter() - t_start) * 1e3:.2f} ms")
            return 0

    write_wav(args.save_path, audio, resp.sample_rate)
    for stage, ms in resp.timings.items():     # a str names a route (decode_route)
        print(f"{stage} = {ms}" if isinstance(ms, str) else f"{stage} = {ms:.2f} ms")
    total_ms = (time.perf_counter() - t_start) * 1e3
    print(f"total time = {total_ms:.2f} ms")
    if resp.duration_s:
        print(f"rtf = {total_ms / 1e3 / resp.duration_s:.4f} "
              "(generation seconds per audio second, incl. model load)")
    print(f"wrote {len(audio)} samples ({len(audio) / resp.sample_rate:.2f}s) "
          f"to {args.save_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
