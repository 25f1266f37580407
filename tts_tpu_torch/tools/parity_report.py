"""Real-checkpoint parity harness: the port's copy of `tools/parity_report.py`.

One command to validate a GGUF checkpoint, on the card by default:

    python -m tts_tpu_torch.tools.parity_report model.gguf \
        [--ref-wav reference_output.wav] [--text "..."] [--voice af_heart] \
        [--seed 0] [--json report.json] [--device cuda]

Per-stage report, with the JAX tool's flags, keys, JSON and printed lines:
  - checkpoint inventory (arch, tensor dtypes, quantization mix)
  - text front-end: phoneme string + token ids (kokoro; prompt ids elsewhere)
  - duration curve (kokoro: per-token durations from the prosody head,
    `KokoroModel.predict_durations`)
  - the AR models' stage trace (`capture_trace` / `last_trace`: prompt ids,
    step-0 logit stats, the token stream's head and EOS step, codec streams)
  - PCM stats: samples, seconds, RMS, peak
  - vs --ref-wav (a WAV from the reference binary, or a saved run of this
    tool, for the SAME checkpoint + text): length ratio, best-lag normalized
    cross-correlation, log-spectral distance -> MATCH / CLOSE / MISMATCH.

`--device` defaults to cuda; with no card the runner's loader raises
TTSError (nothing falls back to the CPU).  Greedy AR requests take the
speculative loop unless TTS_TPU_NO_SPEC is set, as in the runners.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tts_tpu_torch.core.gguf import GGUFFile
from tts_tpu_torch.models.registry import runner_from_file
from tts_tpu_torch.runtime.api import GenerationConfig
from tts_tpu_torch.utils.audio import read_wav, write_wav

DEFAULT_TEXT = "The quick brown fox jumps over the lazy dog."


def checkpoint_inventory(path: str) -> dict:
    with GGUFFile(path) as f:
        arch = f.kv.get("general.architecture", "?")
        types: dict[str, int] = {}
        n_params = 0
        for t in f.tensors.values():
            types[t.ggml_type.name] = types.get(t.ggml_type.name, 0) + 1
            n = 1
            for d in t.shape:
                n *= int(d)
            n_params += n
    return {"architecture": arch, "tensor_types": types,
            "total_parameters": n_params}


def audio_stats(audio: np.ndarray, sr: int) -> dict:
    if not len(audio):
        return {"samples": 0, "seconds": 0.0, "rms": 0.0, "peak": 0.0}
    return {"samples": int(len(audio)), "seconds": float(len(audio) / sr),
            "rms": float(np.sqrt(np.mean(audio.astype(np.float64) ** 2))),
            "peak": float(np.abs(audio).max())}


def best_lag_correlation(a: np.ndarray, b: np.ndarray,
                         max_lag: int = 4800) -> tuple[float, int]:
    """Max normalized cross-correlation over +-max_lag sample shifts (the
    reference and this runtime may disagree on leading padding)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    n = min(len(a), len(b))
    if n < 256:
        return 0.0, 0
    best, best_lag = -1.0, 0
    for lag in range(-max_lag, max_lag + 1, 160):   # 160 = 6.7ms @ 24k coarse
        aa = a[max(lag, 0): max(lag, 0) + n - abs(lag)]
        bb = b[max(-lag, 0): max(-lag, 0) + n - abs(lag)]
        m = min(len(aa), len(bb))
        if m < 256:
            continue
        aa, bb = aa[:m] - aa[:m].mean(), bb[:m] - bb[:m].mean()
        denom = np.sqrt((aa ** 2).sum() * (bb ** 2).sum())
        if denom > 0:
            c = float((aa * bb).sum() / denom)
            if c > best:
                best, best_lag = c, lag
    # refine around the coarse peak
    for lag in range(best_lag - 160, best_lag + 161):
        aa = a[max(lag, 0): max(lag, 0) + n - abs(lag)]
        bb = b[max(-lag, 0): max(-lag, 0) + n - abs(lag)]
        m = min(len(aa), len(bb))
        if m < 256:
            continue
        aa, bb = aa[:m] - aa[:m].mean(), bb[:m] - bb[:m].mean()
        denom = np.sqrt((aa ** 2).sum() * (bb ** 2).sum())
        if denom > 0:
            c = float((aa * bb).sum() / denom)
            if c > best:
                best, best_lag = c, lag
    return best, best_lag


def log_spectral_distance(a: np.ndarray, b: np.ndarray,
                          n_fft: int = 1024, hop: int = 256) -> float:
    """Median per-frame L2 distance between log-magnitude spectra (dB-ish).
    Robust to small phase/alignment differences that PCM correlation
    punishes."""
    n = min(len(a), len(b))
    if n < n_fft:
        return float("nan")
    win = np.hanning(n_fft)

    def spec(x):
        frames = [x[i: i + n_fft] * win
                  for i in range(0, n - n_fft, hop)]
        return np.log10(np.abs(np.fft.rfft(np.stack(frames), axis=-1)) + 1e-6)

    sa, sb = spec(a.astype(np.float64)), spec(b.astype(np.float64))
    return float(np.median(np.sqrt(np.mean((sa - sb) ** 2, axis=-1))))


def kokoro_stages(runner, text: str, voice: str) -> dict:
    """Kokoro-only intermediate stages: phonemes, tokens, durations."""
    import re

    normalized = re.sub(r"[,;:]", "--", text).replace("\n", " ")
    phonemes = runner.phonemizer.text_to_phonemes(normalized)
    stripped = re.sub(r"[.!?]", "", phonemes).strip()
    cfg = runner.model.cfg
    tokens = [cfg.bos_token_id] + runner.tokenizer.tokenize(stripped) + [cfg.eos_token_id]
    _, _, durations, _ = runner.model.predict_durations(tokens, voice)
    durations = durations.float().cpu().numpy()
    return {"phonemes": phonemes,
            "n_tokens": len(tokens),
            "durations": [float(d) for d in durations],
            "total_frames": int(durations.sum())}


def run_report(model_path: str, text: str, voice: str, seed: int,
               ref_wav: str | None = None, max_tokens: int = 0, device=None):
    """-> (report dict, the TTSResponse), the model loaded on `device`
    (the card when None)."""
    report: dict = {"model": model_path, "text": text,
                    "checkpoint": checkpoint_inventory(model_path)}
    config = GenerationConfig(voice=voice, seed=seed, sample=False,
                              max_tokens=max_tokens)
    runner = runner_from_file(model_path, config, device=device)
    report["checkpoint"]["voices"] = runner.list_voices()[:20]
    if not voice and runner.list_voices():
        config.voice = voice = runner.list_voices()[0]
    report["voice"] = voice

    if runner.architecture == "kokoro":
        report["stages"] = kokoro_stages(runner, text, voice)
    else:
        # AR models capture their own stage trace during generate(): prompt
        # ids, step-0 logit stats, token stream head + EOS step, per-head
        # codec code streams (runner.capture_trace / runner.last_trace)
        runner.capture_trace = True

    resp = runner.generate(text, config)
    if runner.architecture != "kokoro":
        runner.capture_trace = False
        if getattr(runner, "last_trace", None):
            report["stages"] = runner.last_trace
    report["audio"] = audio_stats(resp.audio, resp.sample_rate)
    report["audio"]["sample_rate"] = resp.sample_rate
    report["timings_ms"] = {k: round(v, 2) for k, v in resp.timings.items()
                            if isinstance(v, (int, float))}

    if ref_wav:
        ref, ref_sr = read_wav(ref_wav)
        cmp: dict = {"ref_wav": ref_wav,
                     "ref": audio_stats(ref, ref_sr)}
        if ref_sr != resp.sample_rate:
            cmp["note"] = (f"sample-rate mismatch ({ref_sr} vs "
                           f"{resp.sample_rate}); comparison skipped")
        elif not len(resp.audio) or not len(ref):
            cmp["note"] = "empty audio on one side; comparison skipped"
        else:
            corr, lag = best_lag_correlation(resp.audio, ref)
            cmp["length_ratio"] = float(len(resp.audio) / len(ref))
            cmp["pcm_correlation"] = corr
            cmp["best_lag_samples"] = lag
            cmp["log_spectral_distance"] = log_spectral_distance(
                resp.audio, ref)
            cmp["verdict"] = ("MATCH" if corr > 0.95 else
                              "CLOSE" if corr > 0.8 else "MISMATCH")
        report["vs_reference"] = cmp
    return report, resp


def print_report(report: dict) -> None:
    ck = report["checkpoint"]
    print(f"== parity report: {report['model']}")
    print(f"   arch={ck['architecture']} params={ck['total_parameters']:,} "
          f"tensors={ck['tensor_types']}")
    print(f"   voice={report.get('voice') or '(default)'} "
          f"text={report['text']!r}")
    if "stages" in report:
        st = report["stages"]
        if "phonemes" in st:                       # kokoro
            print(f"-- phonemes: {st['phonemes']!r}")
            d = st["durations"]
            print(f"-- durations: {st['n_tokens']} tokens -> "
                  f"{st['total_frames']} frames "
                  f"(min {min(d):.0f} / mean {sum(d) / len(d):.1f} / max {max(d):.0f})")
        else:                                      # AR models
            print(f"-- prompt: {st['n_prompt_tokens']} tokens, "
                  f"first {st['prompt_ids']}")
            s0 = st["step0_logits"]
            if "per_head_argmax" in s0:            # dia / parler multihead
                print(f"-- step-0 logits: per-head argmax "
                      f"{s0['per_head_argmax']}, head0 "
                      f"min/mean/max {s0['head0']['min']:.3f}/"
                      f"{s0['head0']['mean']:.3f}/{s0['head0']['max']:.3f}")
                print(f"-- decode: {st['n_steps']} steps "
                      f"(head-0 EOS @ {st['eos_step_head0']}), "
                      f"{st['n_frames']} frames; first frames "
                      f"{st['codes_first_frames'][:3]}")
            else:                                  # orpheus single head
                print(f"-- step-0 logits: argmax {s0['argmax']} "
                      f"min/mean/max {s0['min']:.3f}/{s0['mean']:.3f}/"
                      f"{s0['max']:.3f}, top {s0['top_ids']}")
                print(f"-- decode: {st['n_tokens']} tokens "
                      f"(EOS @ {st['eos_step']}), first {st['tokens_first'][:12]}")
                print(f"-- codec heads: lengths {st['head_lengths']}, "
                      f"streams {[h[:6] for h in st['head_streams']]}")
    au = report["audio"]
    print(f"-- audio: {au['samples']} samples = {au['seconds']:.2f}s @ "
          f"{au['sample_rate']} Hz, rms={au['rms']:.4f} peak={au['peak']:.4f}")
    if report.get("timings_ms"):
        print(f"-- timings: {report['timings_ms']}")
    if "vs_reference" in report:
        vs = report["vs_reference"]
        if "note" in vs:
            print(f"-- vs reference: {vs['note']}")
        else:
            print(f"-- vs reference ({vs['ref_wav']}): "
                  f"corr={vs['pcm_correlation']:.4f} @ lag "
                  f"{vs['best_lag_samples']}, length ratio "
                  f"{vs['length_ratio']:.3f}, LSD "
                  f"{vs['log_spectral_distance']:.3f} -> {vs['verdict']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="GGUF checkpoint path")
    p.add_argument("--text", default=DEFAULT_TEXT)
    p.add_argument("--voice", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-tokens", type=int, default=0,
                   help="cap AR decode steps (0 = model default)")
    p.add_argument("--ref-wav", default=None,
                   help="WAV produced by the reference binary from the same "
                        "checkpoint + text")
    p.add_argument("--save-wav", default=None,
                   help="also write our generated audio here")
    p.add_argument("--json", default=None, help="write the report as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device to run the model on (no card: TTSError)")
    args = p.parse_args(argv)

    report, resp = run_report(args.model, args.text, args.voice, args.seed,
                              ref_wav=args.ref_wav, max_tokens=args.max_tokens,
                              device=args.device)
    print_report(report)
    if args.save_wav:
        write_wav(args.save_wav, resp.audio, resp.sample_rate)
        print(f"-- wrote {args.save_wav}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"-- wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
