"""HF/torch checkpoint -> GGUF converters (the py-gguf equivalent), on the port.

The port's own copy of `tts_tpu/convert/from_hf.py`: the same mappings and
CLI, writing through the port's `core/gguf.py`.  `convert_parler` encodes
the conditional prompt with the port's T5 (`models/t5.py`) on `device`
(default cuda; `--device` on the CLI).  Each converter maps a torch state
dict onto the GGUF tensor layout consumed by the loaders (and by the
reference C++ runtime — the layouts are identical, parity:
py-gguf/tts_encoders/*).  The mapping helpers are pure functions over
{name: np.ndarray} so they are unit-testable without downloading
checkpoints; the CLI entry points load real models via torch/transformers
when available, importing those packages only inside the converters.

Usage:
  python -m tts_tpu_torch.convert.from_hf kokoro --repo hexgrad/Kokoro-82M --out kokoro.gguf
  python -m tts_tpu_torch.convert.from_hf orpheus --repo canopylabs/orpheus-3b-0.1-ft \
      --out orpheus.gguf
  python -m tts_tpu_torch.convert.from_hf parler --repo ./parler-tts-mini-v1 --out parler.gguf
"""

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# shared helpers (pure numpy)
# ---------------------------------------------------------------------------

def regularize_weight_norm(weight_g: np.ndarray, weight_v: np.ndarray) -> np.ndarray:
    """weight-norm -> plain weight: g * v / ||v|| (per output channel),
    parity: py-gguf/tts_encoders/tensor_util.py."""
    norm = np.linalg.norm(weight_v.reshape(weight_v.shape[0], -1), axis=1)
    shape = (-1,) + (1,) * (weight_v.ndim - 1)
    return (weight_g.reshape(shape) * weight_v / np.maximum(norm.reshape(shape), 1e-12))


def fold_weight_norms(sd: dict) -> dict:
    """Replace every {x.weight_g, x.weight_v} pair with x.weight."""
    out = {}
    for name, arr in sd.items():
        if name.endswith(".weight_v"):
            continue
        if name.endswith(".weight_g"):
            base = name[: -len(".weight_g")]
            out[base + ".weight"] = regularize_weight_norm(arr, sd[base + ".weight_v"])
        else:
            out[name] = arr
    return out


def split_lstm_tensors(base_name: str, tensor_name: str, param: np.ndarray) -> dict:
    """torch LSTM weight_ih_l0[_reverse] etc -> 8 GGUF tensors per direction
    (parity: kokoro_gguf_encoder.prepare_lstm_tensor)."""
    out = {}
    q = param.shape[0] // 4
    chunks = [param[i * q : (i + 1) * q] for i in range(4)]
    layer = int(tensor_name.split("_")[2][1:])
    rev = "reverse_" if "reverse" in tensor_name else ""
    kind = "weights" if "weight" in tensor_name else "biases"
    offset = 0 if "_ih_" in tensor_name else 1
    for i, c in enumerate(chunks):
        out[f"{base_name}.{layer}.{rev}{kind}.{i * 2 + offset}"] = c
    return out


def split_adain(base: str, norm_name: str, param: np.ndarray) -> dict:
    """AdaIN fc weight/bias -> gamma/beta halves
    (parity: prepare_adain_res_block_tensor)."""
    h = param.shape[0] // 2
    suffix = "weight" if param.ndim > 1 else "bias"
    return {f"{base}.{norm_name}_gamma_{suffix}": param[:h],
            f"{base}.{norm_name}_beta_{suffix}": param[h:]}


# ---------------------------------------------------------------------------
# Kokoro
# ---------------------------------------------------------------------------

ALBERT_PARTS = {
    "embeddings.word_embeddings.weight": "token_embd",
    "embeddings.position_embeddings.weight": "position_embd",
    "embeddings.LayerNorm.weight": "norm",
    "embeddings.LayerNorm.bias": "norm_bias",
    "encoder.embedding_hidden_mapping_in.weight": "embd",
    "encoder.embedding_hidden_mapping_in.bias": "embd_bias",
    "full_layer_layer_norm.weight": "attn_norm",
    "full_layer_layer_norm.bias": "attn_norm_bias",
    "attention.query.weight": "q", "attention.query.bias": "q_bias",
    "attention.key.weight": "k", "attention.key.bias": "k_bias",
    "attention.value.weight": "v", "attention.value.bias": "v_bias",
    "attention.dense.weight": "o", "attention.dense.bias": "o_bias",
    "attention.LayerNorm.weight": "ffn_norm",
    "attention.LayerNorm.bias": "ffn_norm_bias",
    "ffn.weight": "ffn", "ffn.bias": "ffn_bias",
    "ffn_output.weight": "ffn_out", "ffn_output.bias": "ffn_out_bias",
}
ALBERT_LAYER_PART = "encoder.albert_layer_groups.0.albert_layers.0."


def map_kokoro_albert(sd: dict) -> dict:
    out = {}
    for name, param in sd.items():
        if name in ALBERT_PARTS:
            out[f"kokoro.albert.{ALBERT_PARTS[name]}"] = param
        elif name.startswith(ALBERT_LAYER_PART) and name[len(ALBERT_LAYER_PART):] in ALBERT_PARTS:
            out[f"kokoro.albert.layer.0.{ALBERT_PARTS[name[len(ALBERT_LAYER_PART):]]}"] = param
        elif name == "embeddings.token_type_embeddings.weight":
            out["kokoro.albert.token_type_embd"] = param[0]
    return out


def map_kokoro_predictor(sd: dict) -> dict:
    """Duration-predictor module (parity: prepare_duration_predictor_tensors)."""
    sd = fold_weight_norms(sd)
    base = "kokoro.duration_predictor"
    out = {}
    for name, param in sd.items():
        parts = name.split(".")
        if name.startswith("text_encoder.lstms."):
            idx = int(parts[2])
            if idx % 2 == 1:  # AdaLayerNorm fc
                h = param.shape[0] // 2
                sfx = "weight" if param.ndim > 1 else "bias"
                out[f"{base}.layers.{idx}.gamma_{sfx}"] = param[:h]
                out[f"{base}.layers.{idx}.beta_{sfx}"] = param[h:]
            else:
                out.update(split_lstm_tensors(f"{base}.layers.{idx}.lstm", parts[-1], param))
        elif name.startswith("lstm."):
            out.update(split_lstm_tensors(f"{base}.duration_lstm", name[5:], param))
        elif name.startswith("shared."):
            out.update(split_lstm_tensors(f"{base}.shared_lstm", name[7:], param))
        elif name == "F0_proj.weight":
            out[f"{base}.f0_proj_kernel"] = param
        elif name == "F0_proj.bias":
            out[f"{base}.f0_proj_bias"] = param
        elif name == "N_proj.weight":
            out[f"{base}.n_proj_kernel"] = param
        elif name == "N_proj.bias":
            out[f"{base}.n_proj_bias"] = param
        elif name == "duration_proj.linear_layer.weight":
            out[f"{base}.duration_proj"] = param
        elif name == "duration_proj.linear_layer.bias":
            out[f"{base}.duration_proj_bias"] = param
        elif parts[0] in ("N", "F0"):
            blocks = "n_blocks" if parts[0] == "N" else "f0_blocks"
            out.update(_map_adain_block(f"{base}.{blocks}.{parts[1]}",
                                        ".".join(parts[2:]), param))
    return out


def _map_adain_block(base: str, sub: str, param: np.ndarray) -> dict:
    parts = sub.split(".")
    if parts[0] in ("norm1", "norm2"):
        if parts[1] == "norm":
            return {}
        return split_adain(base, parts[0], param)
    return {f"{base}.{'_'.join(parts)}": param}


def map_kokoro_decoder(sd: dict) -> dict:
    """Decoder + generator (parity: prepare_decoder_tensors)."""
    sd = fold_weight_norms(sd)
    base = "kokoro.decoder"
    out = {}
    for name, param in sd.items():
        parts = name.split(".")
        if parts[0] == "generator":
            sub = ".".join(parts[1:])
            g = f"{base}.generator"
            gp = sub.split(".")
            if gp[0] == "m_source":
                out[f"{g}.m_source_{gp[-1]}"] = param
            elif gp[0] == "noise_convs":
                out[f"{g}.noise_blocks.{gp[1]}.conv_{gp[-1]}"] = param
            elif gp[0] == "noise_res":
                out.update(_map_gen_res_block_forward(
                    f"{g}.noise_blocks.{gp[1]}.resblock", gp[2:], param))
            elif gp[0] == "ups":
                out[f"{g}.{sub}"] = param
            elif gp[0] == "resblocks":
                out.update(_map_gen_res_block_forward(f"{g}.resblocks.{gp[1]}", gp[2:], param))
            elif gp[0] == "conv_post":
                out[f"{g}.conv_post_{gp[-1]}"] = param
        elif parts[0] == "decode":
            out.update(_map_adain_block(f"{base}.decoder_blocks.{parts[1]}",
                                        ".".join(parts[2:]), param))
        elif parts[0] == "encode":
            out.update(_map_adain_block(f"{base}.encoder_block",
                                        ".".join(parts[1:]), param))
        elif parts[0] in ("F0_conv", "N_conv"):
            out[f"{base}.{'_'.join(parts).lower()}"] = param
        elif parts[0] == "asr_res":
            out[f"{base}.asr_conv_{parts[-1]}"] = param
    return out


def _map_gen_res_block_forward(base: str, gp: list, param: np.ndarray) -> dict:
    """gp like ['adain1d_1', '0', 'fc', 'weight'] or ['convs1', '0', 'weight']."""
    head = gp[0]
    if head.startswith("adain"):
        if gp[2] == "norm":
            return {}
        n = head[-1]
        h = param.shape[0] // 2
        sfx = gp[-1]
        return {f"{base}.{gp[1]}.gamma{n}_{sfx}": param[:h],
                f"{base}.{gp[1]}.beta{n}_{sfx}": param[h:]}
    if gp[-1] in ("weight", "bias"):
        return {f"{base}.{gp[1]}.{head}_{gp[-1]}": param}
    return {f"{base}.{gp[1]}.{head}": param}


def map_kokoro_text_encoder(sd: dict) -> dict:
    sd = fold_weight_norms(sd)
    base = "kokoro.text_encoder"
    out = {}
    for name, param in sd.items():
        parts = name.split(".")
        if parts[0] == "embedding":
            out[f"{base}.embedding_weight"] = param
        elif parts[0] == "lstm":
            out.update(split_lstm_tensors(f"{base}.lstm", parts[1], param))
        elif parts[0] == "cnn":
            # cnn.{i}.{0|1}...: 0 = weight-normed conv, 1 = LayerNorm
            idx = int(parts[1])
            if parts[2] == "0":
                out[f"{base}.layers.{idx}.{parts[-1]}"] = param
            else:
                gb = "gamma" if parts[-1] == "weight" else "beta"
                out[f"{base}.layers.{idx}.{gb}"] = param
    return out


# ---------------------------------------------------------------------------
# Orpheus (HF Llama) + SNAC
# ---------------------------------------------------------------------------

def map_orpheus_llama(sd: dict) -> dict:
    """HF LlamaForCausalLM state dict -> orpheus.* GGUF names
    (parity: py-gguf orpheus_gguf_encoder.prepare_orpheus_tensors: every
    backbone name keeps its HF path, '.weight' stripped, 'orpheus.' prefix)."""
    out = {}
    for name, param in sd.items():
        if name.startswith("model."):
            name = name[len("model."):]
        if not name.endswith(".weight"):
            continue
        out[f"orpheus.{name[:-len('.weight')]}"] = param
    return out


def llama3_rope_factors(head_dim: int, theta: float, rope_scaling: dict) -> np.ndarray:
    """Per-dimension frequency divisors for llama-3 scaled RoPE
    (parity: orpheus_gguf_encoder.prepare_rope_frequencies — the GGUF stores
    the divisor applied to each base frequency)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    factor = rope_scaling.get("factor", 8.0)
    low = rope_scaling.get("low_freq_factor", 1.0)
    high = rope_scaling.get("high_freq_factor", 4.0)
    old_ctx = rope_scaling.get("original_max_position_embeddings", 8192)
    low_wavelen = old_ctx / low
    high_wavelen = old_ctx / high
    out = []
    for f in freqs:
        wavelen = 2 * math.pi / f
        if wavelen < high_wavelen:
            out.append(1.0)
        elif wavelen > low_wavelen:
            out.append(factor)
        else:
            smooth = (old_ctx / wavelen - low) / (high - low)
            out.append(1.0 / ((1 - smooth) / factor + smooth))
    return np.asarray(out, np.float32)


SNAC_RESIDUAL_UNIT_PARTS = {
    "block.0.alpha": "res.initial.alpha",
    "block.1.bias": "res.initial.bias",
    "block.1.weight": "res.initial.weight",
    "block.2.alpha": "res.final.alpha",
    "block.3.bias": "res.final.bias",
    "block.3.weight": "res.final.weight",
}


def simplify_snac_name(name: str) -> str | None:
    """snac decoder.model parameter path -> snac.* GGUF suffix
    (parity: orpheus_gguf_encoder.simplify_snac_name)."""
    parts = name.split(".")
    idx = int(parts[0])
    if idx == 6:
        return "alpha_out"
    if idx == 7:
        return f"final.{parts[1]}"
    if idx == 0:
        return f"in.{parts[1]}"
    if idx == 1:
        return f"up.{parts[1]}"
    idx -= 2
    layer_index = int(parts[2])
    if layer_index == 0:
        return f"layers.{idx}.alpha"
    if layer_index == 1:
        return f"layers.{idx}.{parts[-1]}"
    if layer_index == 2:
        return f"layers.{idx}.noise_{parts[-1]}"
    key = ".".join(parts[-3:])
    if key not in SNAC_RESIDUAL_UNIT_PARTS:
        return None
    return (f"layers.{idx}.residual_unit.{layer_index - 3}."
            f"{SNAC_RESIDUAL_UNIT_PARTS[key]}")


def fold_parametrizations(sd: dict) -> dict:
    """torch.nn.utils.parametrizations weight-norm pairs
    ({base}.parametrizations.weight.original0/1 = g/v) -> {base}.weight."""
    out = {}
    for name, arr in sd.items():
        if ".parametrizations.weight.original0" in name:
            base = name.split(".parametrizations.")[0]
            v = sd[base + ".parametrizations.weight.original1"]
            out[base + ".weight"] = regularize_weight_norm(arr, v)
        elif ".parametrizations." in name:
            continue
        else:
            out[name] = arr
    return out


def map_snac(decoder_sd: dict, quantizer_sd: dict) -> dict:
    """snac decoder.model + quantizer state dicts -> snac.* GGUF names."""
    out = {}
    for name, arr in fold_parametrizations(quantizer_sd).items():
        out[f"snac.{name}"] = arr
    for name, arr in fold_parametrizations(decoder_sd).items():
        simple = simplify_snac_name(name)
        if simple is not None:
            out[f"snac.{simple}"] = arr
    return out


# ---------------------------------------------------------------------------
# DAC (descript-audio-codec decoder + quantizers)
# ---------------------------------------------------------------------------

DAC_DECODER_PARTS = {
    "model.0.bias": "initial.bias", "model.0.weight": "initial.weight",
    "model.1": "decoder_block.1", "model.2": "decoder_block.2",
    "model.3": "decoder_block.3", "model.4": "decoder_block.4",
    "model.5.alpha": "final.alpha",
    "model.6.bias": "final.bias", "model.6.weight": "final.weight",
}
DAC_DECODER_BLOCK_PARTS = {
    "block.2": "residual_unit.0", "block.3": "residual_unit.1",
    "block.4": "residual_unit.2", "block.0.alpha": "final.alpha",
    "block.1.bias": "final.bias", "block.1.weight": "final.weight",
}
DAC_RESIDUAL_UNIT_PARTS = SNAC_RESIDUAL_UNIT_PARTS  # identical block layout


def map_dac(decoder_sd: dict, quantizer_sd: dict,
            prefix: str = "audio_encoder.") -> dict:
    """DAC decoder + quantizer state dicts (module-level names like
    'model.0.weight' / 'quantizers.0.out_proj.weight_g') -> GGUF names
    (parity: py-gguf dac_gguf_encoder)."""
    out = {}
    for name, arr in fold_weight_norms(fold_parametrizations(decoder_sd)).items():
        parts = name.split(".block")
        mapped = []
        for i, part in enumerate(parts):
            part = f"block{part}" if i > 0 else part
            table = (DAC_DECODER_PARTS, DAC_DECODER_BLOCK_PARTS,
                     DAC_RESIDUAL_UNIT_PARTS)[i]
            if part not in table:
                mapped = None
                break
            mapped.append(table[part])
        if mapped is not None:
            out[prefix + ".".join(mapped)] = arr
    for name, arr in fold_weight_norms(fold_parametrizations(quantizer_sd)).items():
        if "in_proj" in name:
            continue                      # encoder-side projection, unused
        out[prefix + name] = arr
    return out


# ---------------------------------------------------------------------------
# Parler-TTS (decoder + precomputed text encoding handled by caller)
# ---------------------------------------------------------------------------

def map_parler_decoder(sd: dict) -> dict:
    """ParlerTTSForConditionalGeneration state dict (raw safetensors names,
    no parler_tts package needed) -> decoder.* GGUF names
    (parity: py-gguf parler_tts_gguf_encoder.prepare_decoder_tensors)."""
    out = {}
    dec_prefix = "decoder.model.decoder."
    for name, arr in sd.items():
        if name == "embed_prompts.weight":
            out["decoder.embed_prompts"] = arr
        elif name.startswith("decoder.lm_heads.") and name.endswith(".weight"):
            i = name.split(".")[2]
            out[f"decoder.lm_heads.{i}.weight.head"] = arr
        elif name.startswith(dec_prefix):
            sub = name[len(dec_prefix):]
            if sub == "embed_positions.weights":
                out["decoder.positional_embed"] = arr
            else:
                out[f"decoder.{sub}"] = arr    # loader names keep .weight/.bias
    return out


# ---------------------------------------------------------------------------
# Dia (encoder-decoder; DenseGeneral weights reshaped to [out, in])
# ---------------------------------------------------------------------------

def _dense_general_qkv(arr: np.ndarray) -> np.ndarray:
    """Dia DenseGeneral q/k/v weight (in, heads, head_dim) -> [out, in]."""
    return arr.reshape(arr.shape[0], -1).T


def _dense_general_o(arr: np.ndarray) -> np.ndarray:
    """Dia DenseGeneral o weight (heads, head_dim, embed) -> [embed, in]."""
    return arr.reshape(-1, arr.shape[-1]).T


def map_dia(sd: dict) -> dict:
    """Dia checkpoint state dict ('encoder.*'/'decoder.*' module names) ->
    dia.* GGUF names (parity: py-gguf dia_gguf_encoder)."""
    out = {}
    for name, arr in sd.items():
        parts = name.split(".")
        side = parts[0]
        if side not in ("encoder", "decoder"):
            continue
        base = f"dia.{side}"
        rest = parts[1:]
        if rest[0] in ("embedding", "norm"):
            out[f"{base}.{rest[0]}"] = arr
        elif rest[0] == "embeddings":
            out[f"{base}.embeddings.{rest[1]}"] = arr
        elif rest[0] == "logits_dense":
            for i in range(arr.shape[1]):
                out[f"{base}.heads.{i}"] = arr[:, i].T
        elif rest[0] == "layers":
            nn = f"{base}.layers.{rest[1]}"
            mod = rest[2]
            if mod == "mlp" and rest[3] == "wi_fused":
                out[f"{nn}.gate"] = arr[:, 0].T
                out[f"{nn}.up"] = arr[:, 1].T
            elif mod == "mlp":
                out[f"{nn}.{rest[3]}"] = arr.T
            elif mod == "self_attention":
                fn = _dense_general_o if rest[3] == "o_proj" else _dense_general_qkv
                key = f"self_{rest[3]}" if side == "decoder" else rest[3]
                out[f"{nn}.{key}"] = fn(arr)
            elif mod == "cross_attention":
                fn = _dense_general_o if rest[3] == "o_proj" else _dense_general_qkv
                out[f"{nn}.cross_{rest[3]}"] = fn(arr)
            else:
                out[f"{nn}.{rest[2]}"] = arr
    return out


# ---------------------------------------------------------------------------
# T5 encoder (HF T5EncoderModel)
# ---------------------------------------------------------------------------

def map_t5_encoder(sd: dict) -> dict:
    """HF T5EncoderModel state dict -> t5encoder.* GGUF names
    (parity: py-gguf t5_encoder_gguf_encoder.py:79-90)."""
    out = {}
    for name, param in sd.items():
        if name in ("shared.weight", "encoder.embed_tokens.weight"):
            out["t5encoder.token_embd"] = param
        elif name == "encoder.final_layer_norm.weight":
            out["t5encoder.enc.final_layer_norm"] = param
        elif name.startswith("encoder.block."):
            parts = name.split(".")
            i = int(parts[2])
            blk = f"t5encoder.enc.blk.{i}"
            rest = ".".join(parts[3:])
            if rest == "layer.0.SelfAttention.relative_attention_bias.weight":
                out[f"{blk}.attn_rel_b"] = param
            elif rest.startswith("layer.0.SelfAttention."):
                out[f"{blk}.attn_{parts[-2]}"] = param
            elif rest == "layer.0.layer_norm.weight":
                out[f"{blk}.attn_norm"] = param
            elif rest == "layer.1.DenseReluDense.wi_0.weight":
                out[f"{blk}.ffn_up"] = param
            elif rest == "layer.1.DenseReluDense.wi_1.weight":
                out[f"{blk}.ffn_gate"] = param
            elif rest == "layer.1.DenseReluDense.wo.weight":
                out[f"{blk}.ffn_down"] = param
            elif rest == "layer.1.layer_norm.weight":
                out[f"{blk}.ffn_norm"] = param
    return out


def convert_orpheus(repo: str, out_path: str, snac_repo: str | None = None):
    """Orpheus-3B + SNAC -> GGUF.  `repo`/`snac_repo` may be local paths
    (works offline) or hub ids."""
    import json as _json

    from transformers import AutoModelForCausalLM, AutoTokenizer

    from tts_tpu_torch.core.gguf import GGUFWriter

    model = AutoModelForCausalLM.from_pretrained(repo).eval()
    cfg = model.config
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    tensors = map_orpheus_llama(sd)
    if "orpheus.lm_head" not in tensors:      # tied embeddings
        tensors["orpheus.lm_head"] = tensors["orpheus.embed_tokens"]
    head_dim = getattr(cfg, "head_dim", cfg.hidden_size // cfg.num_attention_heads)
    tensors["orpheus.rope_frequencies"] = llama3_rope_factors(
        head_dim, cfg.rope_theta, cfg.rope_scaling or {})

    if snac_repo:
        try:
            from snac import SNAC
            sm = SNAC.from_pretrained(snac_repo).eval()
            dec = {k: v.detach().float().numpy()
                   for k, v in sm.decoder.model.state_dict().items()}
            qnt = {k: v.detach().float().numpy()
                   for k, v in sm.quantizer.state_dict().items()}
            tensors.update(map_snac(dec, qnt))
        except ImportError:
            raise SystemExit("the `snac` package is required for --snac-repo")

    w = GGUFWriter(out_path)
    kv = {
        "general.architecture": "orpheus",
        "orpheus.layers": cfg.num_hidden_layers,
        "orpheus.hidden_size": cfg.hidden_size,
        "orpheus.attn_heads": cfg.num_attention_heads,
        "orpheus.kv_attn_heads": cfg.num_key_value_heads,
        "orpheus.head_dim": head_dim,
        "orpheus.vocab_size": cfg.vocab_size,
        "orpheus.stopping_token_id": 128258,
    }
    tok = AutoTokenizer.from_pretrained(repo)
    vocab = tok.get_vocab()
    ordered = [""] * (max(vocab.values()) + 1)
    for t, i in vocab.items():
        ordered[i] = t
    kv["tokenizer.ggml.tokens"] = ordered
    tj = _json.loads(tok._tokenizer.to_str())
    kv["tokenizer.ggml.merges"] = [
        m if isinstance(m, str) else " ".join(m)
        for m in tj["model"]["merges"]]
    kv["tokenizer.ggml.bos_token_id"] = tok.bos_token_id or 128000
    kv["tokenizer.ggml.eos_token_id"] = tok.eos_token_id or 128009
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    print(f"wrote {out_path} ({len(tensors)} tensors)")


# ---------------------------------------------------------------------------
# CLI (requires torch + the model packages; mapping logic above is offline)
# ---------------------------------------------------------------------------

def convert_kokoro(repo: str, out_path: str, voices=None,
                   phonemizer_gguf: str | None = None):
    """Full Kokoro conversion: model weights + voice packs + config KVs.

    Requires the `kokoro` package and network/local access to the checkpoint
    repo (same prerequisites as py-gguf).  `phonemizer_gguf` supplies the
    TTS-rules tables (phonemizer.*); without it, phonemizer.type is set to
    espeak."""
    import torch
    from huggingface_hub import hf_hub_download
    from kokoro import KPipeline

    from tts_tpu_torch.core.gguf import GGUFFile, GGUFWriter

    pipeline = KPipeline(lang_code="a", repo_id=repo)
    model = pipeline.model
    tensors = {}
    to_np = lambda sd: {k: v.detach().float().numpy() for k, v in sd.items()}
    tensors.update(map_kokoro_albert(to_np(model.bert.state_dict())))
    tensors.update(map_kokoro_predictor(to_np(model.predictor.state_dict())))
    tensors.update(map_kokoro_text_encoder(to_np(model.text_encoder.state_dict())))
    tensors.update(map_kokoro_decoder(to_np(model.decoder.state_dict())))
    tensors["kokoro.duration_predictor.encode"] = model.bert_encoder.weight.detach().numpy()
    tensors["kokoro.duration_predictor.encode_bias"] = model.bert_encoder.bias.detach().numpy()

    voices = voices or ["af_heart"]
    for v in voices:
        f = hf_hub_download(repo_id=repo, filename=f"voices/{v}.pt")
        tensors[f"kokoro.voice_tensors.{v}"] = (
            torch.load(f, weights_only=True).squeeze(1).numpy())

    w = GGUFWriter(out_path)
    w.add_kv("general.architecture", "kokoro")
    # geometry KVs mirror builder_kokoro (config.json values are static for
    # Kokoro-82M; py-gguf reads the same fields)
    from tts_tpu_torch.convert.builder_kokoro import KokoroDims, build_kokoro_tensors
    _, kv = build_kokoro_tensors(KokoroDims.kokoro_82m(),
                                 np.random.default_rng(0), voices=voices)
    kv["kokoro.voices"] = list(voices)
    vocab = {v: k for k, v in model.vocab.items()}
    token_list = [""] + [vocab.get(i + 1, "") for i in range(max(vocab) if vocab else 0)]
    kv["tokenizer.ggml.tokens"] = token_list
    if phonemizer_gguf:
        with GGUFFile(phonemizer_gguf) as pf:
            for key in ("phonemizer.graphemes", "phonemizer.rules.keys",
                        "phonemizer.rules.phonemes", "phonemizer.dictionary.keys",
                        "phonemizer.dictionary.values"):
                kv[key] = list(pf.kv[key])
        kv["phonemizer.type"] = 0
    else:
        kv["phonemizer.type"] = 1  # espeak
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    print(f"wrote {out_path} ({len(tensors)} tensors, voices: {', '.join(voices)})")


def _load_local_state_dict(path: str) -> dict:
    """Load a checkpoint directory or file into {name: np.ndarray} without
    instantiating any model class (works offline, no model packages)."""
    import glob
    import os

    import torch

    files = []
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors"))) or \
            sorted(glob.glob(os.path.join(path, "pytorch_model*.bin"))) or \
            sorted(glob.glob(os.path.join(path, "*.pth")))
        if not files:
            raise SystemExit(f"no checkpoint files found in {path}")
    else:
        files = [path]
    sd = {}
    for f in files:
        if f.endswith(".safetensors"):
            from safetensors.numpy import load_file
            sd.update(load_file(f))
        else:
            raw = torch.load(f, map_location="cpu", weights_only=True)
            if isinstance(raw, dict) and "state_dict" in raw:
                raw = raw["state_dict"]
            sd.update({k: v.float().numpy() for k, v in raw.items()})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _unigram_vocab_from_tokenizer_json(path: str):
    import json as _json

    with open(path) as f:
        tj = _json.load(f)
    vocab = tj["model"]["vocab"]              # [[token, score], ...]
    tokens = [t.replace("▁", " ") for t, _ in vocab]
    scores = [float(s) for _, s in vocab]
    unk = tj["model"].get("unk_id", 0)
    return tokens, scores, unk


def convert_parler(repo: str, out_path: str, prompt: str = "female voice",
                   device="cuda"):
    """Parler-TTS -> GGUF from a raw checkpoint (no parler_tts package):
    decoder + DAC tensors are mapped from the state dict; the conditional
    text encoding is computed with the port's T5 graph on `device` from the
    checkpoint's own text_encoder weights (parity:
    prepare_text_encoding_tensors)."""
    import json as _json
    import os

    from tts_tpu_torch.core.gguf import GGUFWriter

    sd = _load_local_state_dict(repo)
    tensors = map_parler_decoder(sd)
    dec_sd = {k[len("audio_encoder.model.decoder."):]: v for k, v in sd.items()
              if k.startswith("audio_encoder.model.decoder.")}
    # module-level names used by the mapper start with 'model.'
    dec_sd = {f"model.{k}" if not k.startswith("model.") else k: v
              for k, v in dec_sd.items()}
    qnt_sd = {k[len("audio_encoder.model.quantizer."):]: v for k, v in sd.items()
              if k.startswith("audio_encoder.model.quantizer.")}
    tensors.update(map_dac(dec_sd, qnt_sd))

    with open(os.path.join(repo, "config.json")) as f:
        config = _json.load(f)
    dcfg = config["decoder"]
    acfg = config["audio_encoder"]
    tcfg = config["text_encoder"]

    tok_json = os.path.join(repo, "tokenizer.json")
    tokens, scores, unk = _unigram_vocab_from_tokenizer_json(tok_json)

    # conditional prompt -> precomputed T5 encoding with our own graph
    t5_tensors = map_t5_encoder({k[len("text_encoder."):]: v
                                 for k, v in sd.items()
                                 if k.startswith("text_encoder.")})
    from tts_tpu_torch.models.t5 import T5Config, T5Runner, load_t5_params
    from tts_tpu_torch.text.tokenizers import UnigramTokenizer

    t5cfg = T5Config(n_layers=tcfg["num_layers"], hidden_size=tcfg["d_model"],
                     n_attn_heads=tcfg["num_heads"],
                     vocab_size=tcfg["vocab_size"], output_size=None)
    tokenizer = UnigramTokenizer({t: i for i, t in enumerate(tokens)}, unk,
                                 scores, eos_token=tcfg.get("eos_token_id", 1))
    t5 = T5Runner(t5cfg, load_t5_params(t5_tensors, t5cfg, device), tokenizer)
    encoding = t5.encode(prompt)
    tensors["decoder.text_encoding"] = encoding

    w = GGUFWriter(out_path)
    kv = {
        "general.architecture": "parler-tts",
        "parler-tts.decoder.num_hidden_layers": dcfg["num_hidden_layers"],
        "parler-tts.decoder.hidden_size": dcfg["hidden_size"],
        "parler-tts.decoder.attention.head_count": dcfg["num_attention_heads"],
        "parler-tts.decoder.output_heads": dcfg["num_codebooks"],
        "parler-tts.decoder.out_vocab_size": dcfg["vocab_size"],
        "parler-tts.decoder.audio_vocab_size": acfg["codebook_size"],
        "parler-tts.decoder.context_length": dcfg["max_position_embeddings"],
        "parler-tts.decoder.max_generation": 2580,
        "parler-tts.decoder.encode_length": int(encoding.shape[0]),
        "audio.bos_token_id": dcfg["bos_token_id"],
        "audio.eos_token_id": dcfg["eos_token_id"],
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": np.asarray(scores, np.float32),
        "tokenizer.ggml.unknown_token_id": unk,
        "tokenizer.ggml.eos_token_id": tcfg.get("eos_token_id", 1),
    }
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    print(f"wrote {out_path} ({len(tensors)} tensors)")


def convert_dia(repo: str, out_path: str, dac_path: str):
    """Dia -> GGUF from a raw checkpoint + a DAC checkpoint (no dia package)."""
    import json as _json
    import os

    from tts_tpu_torch.core.gguf import GGUFWriter

    sd = _load_local_state_dict(repo)
    tensors = map_dia(sd)
    dac_sd = _load_local_state_dict(dac_path)
    dec_sd = {k[len("decoder."):]: v for k, v in dac_sd.items()
              if k.startswith("decoder.")}
    qnt_sd = {k[len("quantizer."):]: v for k, v in dac_sd.items()
              if k.startswith("quantizer.")}
    tensors.update(map_dac(dec_sd, qnt_sd))

    cfg_path = os.path.join(repo, "config.json") if os.path.isdir(repo) else None
    config = {}
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = _json.load(f)
    enc = config.get("encoder_config", config.get("model", {}).get("encoder", {}))
    dec = config.get("decoder_config", config.get("model", {}).get("decoder", {}))
    g = lambda d, k, default: int(d.get(k, default)) if isinstance(d, dict) else default

    w = GGUFWriter(out_path)
    kv = {
        "general.architecture": "dia",
        "dia.encoder.layers": g(enc, "n_layer", 12),
        "dia.decoder.layers": g(dec, "n_layer", 18),
        "dia.encoder.hidden_size": g(enc, "n_embd", 1024),
        "dia.decoder.hidden_size": g(dec, "n_embd", 2048),
        "dia.encoder.attn_heads": g(enc, "n_head", 16),
        "dia.decoder.attn_heads": g(dec, "gqa_query_heads", 16),
        "dia.decoder.query_heads": g(dec, "gqa_query_heads", 16)
                                   // max(g(dec, "kv_heads", 4), 1),
        "dia.attn_head_size": g(enc, "head_dim", 128),
        "dia.decoder.output_heads": 9,
        "dia.decoder.output_vocab_size": 1028,
        "dia.decoder.audio_vocab_size": 1024,
        "dia.eos_token_id": 1024,
        "dia.pad_token_id": 1025,
        "dia.bos_token_id": 1026,
        "dia.encoder.max_context_length": g(enc, "max_position_embeddings", 1024),
        "dia.decoder.max_generation_size": 3072,
        "dia.max_delay": 15,
        "dia.cfg_scale": 3.0,
    }
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    print(f"wrote {out_path} ({len(tensors)} tensors)")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="tts_tpu_torch-convert", description=__doc__)
    p.add_argument("model", choices=["kokoro", "parler", "orpheus", "dia", "t5"])
    p.add_argument("--repo", required=True,
                   help="hub id or local checkpoint directory")
    p.add_argument("--out", required=True)
    p.add_argument("--snac-repo", default=None,
                   help="(orpheus) SNAC codec hub id / local path")
    p.add_argument("--dac-path", default=None,
                   help="(dia) DAC codec checkpoint path")
    p.add_argument("--conditional-prompt", default="female voice",
                   help="(parler) voice-conditioning prompt to pre-encode")
    p.add_argument("--device", default="cuda",
                   help="(parler) torch device of the T5 encoder (default: cuda)")
    args = p.parse_args(argv)
    if args.model == "kokoro":
        convert_kokoro(args.repo, args.out)
    elif args.model == "orpheus":
        convert_orpheus(args.repo, args.out, snac_repo=args.snac_repo)
    elif args.model == "parler":
        convert_parler(args.repo, args.out, prompt=args.conditional_prompt,
                       device=args.device)
    elif args.model == "dia":
        if not args.dac_path:
            raise SystemExit("dia conversion requires --dac-path")
        convert_dia(args.repo, args.out, args.dac_path)
    else:
        raise SystemExit(f"converter for {args.model} not wired to a CLI yet; "
                         "use the mapping functions in this module")


if __name__ == "__main__":
    main()
