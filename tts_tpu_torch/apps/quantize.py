"""quantize on the port: GGUF -> GGUF requantization (Q4_0 / Q5_0 / Q8_0 /
F16 / BF16), host-only.

The port's own copy of `tts_tpu/apps/quantize.py`, through the port's
`core/gguf.py` writer: the same flags, rules and printed line, and for the
same input and flags a byte-identical file.

Parity: the reference's examples/quantize — per-architecture allowlists
(quantize_impl.cpp:14-80), KV metadata preserved, pass-through for
incompatible tensors, optional head/text-embedding/cross-KV/DAC-f16 flags.
Quantization runs multithreaded over tensors.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from tts_tpu_torch.core.gguf import GGMLType, GGUFFile, GGUFWriter

VALID_TYPES = {
    "FP16": GGMLType.F16, "F16": GGMLType.F16,
    "Q4_0": GGMLType.Q4_0, "Q4": GGMLType.Q4_0,
    "Q5_0": GGMLType.Q5_0, "Q5": GGMLType.Q5_0,
    "Q8_0": GGMLType.Q8_0, "Q8": GGMLType.Q8_0,
    "BF16": GGMLType.BF16,
}


@dataclass
class QuantizationParams:
    qtype: GGMLType = GGMLType.Q4_0
    quantize_output_heads: bool = False
    quantize_text_embeddings: bool = False
    quantize_cross_attn_kv: bool = False
    convert_dac_to_f16: bool = False
    convert_non_quantized_to_f16: bool = False
    n_threads: int = 4


def _kokoro_is_f16_compatible(name: str) -> bool:
    return ("voice_tensors" not in name and "bias" not in name
            and "gamma" not in name and "beta" not in name
            and "alpha" not in name and not name.endswith("embd")
            and not name.endswith("norm"))


def _kokoro_is_quantizable(name: str, params: QuantizationParams) -> bool:
    dp_parts = {"duration_proj", "encode", "shared_lstm", "duration_lstm", "layers"}
    if not _kokoro_is_f16_compatible(name):
        return False
    if name.startswith("kokoro.albert") or name.startswith("kokoro.text_encoder.lstm"):
        return True
    if name.startswith("kokoro.duration_predictor."):
        parts = name.split(".")
        return len(parts) > 2 and parts[2] in dp_parts
    return False


def _dia_is_quantizable(name: str, params: QuantizationParams) -> bool:
    ok = not name.startswith("audio_encoder") and not name.endswith("norm")
    if not params.quantize_output_heads:
        ok = ok and not name.startswith("dia.decoder.heads")
    return ok


def _parler_is_quantizable(name: str, params: QuantizationParams) -> bool:
    ok = (not name.startswith("audio_encoder")
          and not name.endswith("norm.weight") and not name.endswith("norm.bias")
          and not name.endswith("text_encoding")
          and not name.endswith("positional_embed"))
    if not params.quantize_output_heads:
        ok = ok and not name.endswith("weight.head")
    if not params.quantize_text_embeddings:
        ok = ok and not name.endswith("embed_prompts")
    if not params.quantize_cross_attn_kv:
        ok = ok and not name.endswith("encoder_attn.k_proj.weight") \
             and not name.endswith("encoder_attn.v_proj.weight")
    return ok


def _orpheus_is_quantizable(name: str, params: QuantizationParams) -> bool:
    ok = (not name.startswith("snac.") and "norm" not in name
          and not name.endswith("rope_frequencies"))
    if not params.quantize_output_heads:
        ok = ok and not name.endswith("lm_head")
    return ok


_QUANTIZABLE = {
    "parler-tts": _parler_is_quantizable,
    "dia": _dia_is_quantizable,
    "kokoro": _kokoro_is_quantizable,
    "orpheus": _orpheus_is_quantizable,
}


def quantize_gguf(in_path: str, out_path: str, params: QuantizationParams) -> dict:
    """Returns {"quantized": n, "passthrough": n, "f16": n}."""
    f = GGUFFile(in_path)
    arch = f.architecture
    if arch not in _QUANTIZABLE:
        raise ValueError(f"architecture '{arch}' is not supported for quantization")
    is_quantizable = _QUANTIZABLE[arch]

    w = GGUFWriter(out_path)
    for key, value in f.kv.items():
        w.add_kv(key, value)

    stats = {"quantized": 0, "passthrough": 0, "f16": 0}
    jobs = []
    for name, tensor in f.tensors.items():
        quantize = (tensor.ggml_type == GGMLType.F32
                    and is_quantizable(name, params)
                    and tensor.n_elements % 32 == 0
                    and tensor.shape[-1] % 32 == 0)
        to_f16 = (not quantize and tensor.ggml_type == GGMLType.F32
                  and ((params.convert_dac_to_f16 and name.startswith(("audio_encoder", "snac")))
                       or (params.convert_non_quantized_to_f16
                           and arch == "kokoro" and _kokoro_is_f16_compatible(name))))
        jobs.append((name, tensor, quantize, to_f16))

    def encode(job):
        name, tensor, quantize, to_f16 = job
        if quantize:
            return name, tensor, params.qtype, tensor.to_numpy()
        if to_f16:
            return name, tensor, GGMLType.F16, tensor.to_numpy()
        return name, tensor, None, None

    with ThreadPoolExecutor(max_workers=max(params.n_threads, 1)) as pool:
        results = list(pool.map(encode, jobs))

    for name, tensor, qtype, data in results:
        if qtype is None:
            w.add_raw_tensor(name, tensor.dims, tensor.ggml_type,
                             bytes(tensor.raw()))
            stats["passthrough"] += 1
        elif qtype == GGMLType.F16:
            w.add_tensor(name, data, GGMLType.F16)
            stats["f16"] += 1
        else:
            w.add_tensor(name, data, qtype)
            stats["quantized"] += 1
    w.write()
    f.close()
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quantize", description=__doc__)
    p.add_argument("--model-path", "-mp", required=True)
    p.add_argument("--quantized-model-path", "-qp", required=True)
    p.add_argument("--quantized-type", "-qt", default="Q4_0",
                   choices=sorted(VALID_TYPES))
    p.add_argument("--n-threads", "-nt", type=int, default=4)
    p.add_argument("--convert-dac-to-f16", "-df", action="store_true")
    p.add_argument("--quantize-output-heads", "-qh", action="store_true")
    p.add_argument("--quantize-text-embedding", "-qe", action="store_true")
    p.add_argument("--quantize-cross-attn-kv", "-qkv", action="store_true")
    p.add_argument("--convert-non-quantized-to-f16", "-nqf", action="store_true")
    args = p.parse_args(argv)

    params = QuantizationParams(
        qtype=VALID_TYPES[args.quantized_type],
        quantize_output_heads=args.quantize_output_heads,
        quantize_text_embeddings=args.quantize_text_embedding,
        quantize_cross_attn_kv=args.quantize_cross_attn_kv,
        convert_dac_to_f16=args.convert_dac_to_f16,
        convert_non_quantized_to_f16=args.convert_non_quantized_to_f16,
        n_threads=args.n_threads)
    stats = quantize_gguf(args.model_path, args.quantized_model_path, params)
    print(f"quantized={stats['quantized']} f16={stats['f16']} "
          f"passthrough={stats['passthrough']} -> {args.quantized_model_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
