"""perf_battery on the port: generation benchmark over the Harvard sentences.

The port's own copy of `tts_tpu/apps/perf_battery.py`: the same sentences,
flags, report keys and `--json` line, with the runner on `--device`
(default cuda; a CUDA device with no card exits 1, nothing falls back to
the CPU) and `--profile-dir` capturing a torch.profiler Chrome trace.

Parity: the reference's examples/perf_battery — mean generation time, codec
decode time, throughput, and real-time factor (generation seconds per second
of audio; < 1.0 is faster than real time).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

# IEEE Harvard sentences, lists 1-3 (public domain) — the reference uses 30.
HARVARD_SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.",
    "The girl at the booth sold fifty bonds.",
    "The small pup gnawed a hole in the sock.",
    "The fish twisted and turned on the bent hook.",
    "Press the pants and sew a button on the vest.",
    "The swan dive was far short of perfect.",
    "The beauty of the view stunned the young boy.",
    "Two blue fish swam in the tank.",
    "Her purse was full of useless trash.",
    "The colt reared and threw the tall rider.",
    "It snowed, rained, and hailed the same morning.",
    "Read verse out loud for pleasure.",
]


@contextlib.contextmanager
def _chrome_trace(directory: str, device: str):
    """torch.profiler over the block (CPU ops, and CUDA kernels when the
    runner is on a card), written to `directory`/perf_battery_trace.json."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "perf_battery_trace.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perf_battery", description=__doc__)
    p.add_argument("--model-path", "-mp", required=True)
    p.add_argument("--voice", "-v", default="")
    p.add_argument("--n-sentences", type=int, default=len(HARVARD_SENTENCES))
    p.add_argument("--warmup", type=int, default=1,
                   help="passes over the FULL battery before timing (the first "
                        "pass builds the CUDA kernels and warms cuDNN's and "
                        "cuBLAS's choices for every shape the battery hits, so "
                        "means report steady-state, not first-call); 0 disables")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of the timed battery "
                        "into this directory (a Chrome trace: chrome://tracing, "
                        "Perfetto)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the runner (default: cuda)")
    args = p.parse_args(argv)

    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig, TTSError

    config = GenerationConfig(voice=args.voice, seed=0)
    try:
        runner = runner_from_file(args.model_path, config, device=args.device)
    except TTSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sentences = HARVARD_SENTENCES[: args.n_sentences]

    # warm every sentence's shapes (and the first stream chunk's)
    for _ in range(args.warmup):
        for s in sentences:
            runner.generate(s, config)
        if hasattr(runner, "generate_stream"):
            for _chunk in runner.generate_stream(sentences[0], config):
                break

    gen_times = []
    codec_times = []
    audio_seconds = 0.0
    profile_cm = contextlib.nullcontext()
    if args.profile_dir:
        profile_cm = _chrome_trace(args.profile_dir, args.device)
    with profile_cm:
        for s in sentences:
            t0 = time.perf_counter()
            resp = runner.generate(s, config)
            gen_times.append((time.perf_counter() - t0) * 1e3)
            codec_times.append(resp.timings.get("codec_ms", 0.0))
            audio_seconds += resp.duration_s
            print(f"  {gen_times[-1]:9.2f} ms -> {resp.duration_s:6.2f}s audio",
                  file=sys.stderr)

    mean_gen = sum(gen_times) / len(gen_times)
    median_gen = sorted(gen_times)[len(gen_times) // 2]
    mean_codec = sum(codec_times) / len(codec_times)
    rtf = (sum(gen_times) / 1e3) / max(audio_seconds, 1e-9)
    report = {
        "model": args.model_path,
        "sentences": len(sentences),
        "mean_generation_ms": round(mean_gen, 3),
        # medians exclude first-call outliers (kernel build, cuDNN and
        # cuBLAS choices) when --warmup is 0
        "median_generation_ms": round(median_gen, 3),
        "mean_codec_ms": round(mean_codec, 3),
        "total_audio_seconds": round(audio_seconds, 3),
        "real_time_factor": round(rtf, 6),
    }

    # p50 time-to-first-audio via the streaming path, when supported
    if hasattr(runner, "generate_stream"):
        ttfas = []
        for s in sentences[: min(len(sentences), 10)]:
            t0 = time.perf_counter()
            for _chunk in runner.generate_stream(s, config):
                ttfas.append((time.perf_counter() - t0) * 1e3)
                break
        if ttfas:
            ttfas.sort()
            report["p50_time_to_first_audio_ms"] = round(
                ttfas[len(ttfas) // 2], 3)
    if args.json:
        print(json.dumps(report))
    else:
        print("\n=== perf battery ===")
        for k, v in report.items():
            print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
