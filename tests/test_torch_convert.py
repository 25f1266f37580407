"""The port's converters against the JAX package's: every mapping function
of tts_tpu_torch.convert.from_hf on the same synthetic state dicts;
convert_dia byte-identical and convert_parler identical but for its T5
text encoding (the port's T5 on the CPU, within a stated tolerance), both
on the synthetic checkpoints of tests/test_from_hf_cli.py, and each
converted file generating through the port; the phonemizer trainer's
alignments, rules, exported GGUF (byte-identical) and CLI."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

import torch  # noqa: E402

from test_from_hf_cli import _dac_torch_sd, _invert_weight_norm  # noqa: E402
from test_phonemizer_trainer import LEXICON  # noqa: E402
from tts_tpu.convert import from_hf as jhf  # noqa: E402
from tts_tpu.convert import phonemizer_trainer as jtrainer  # noqa: E402
from tts_tpu_torch.convert import from_hf as thf  # noqa: E402
from tts_tpu_torch.convert import phonemizer_trainer as ttrainer  # noqa: E402
from tts_tpu_torch.core.gguf import GGUFFile  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

# decoder.text_encoding: the port's T5 and JAX's differ in the last bits of
# f32 (sums in another order through the layers), bounded as a share of the
# encoding's peak
TEXT_ENCODING_TOL = 1e-5


def same(a, b) -> bool:
    """Equal structure, key order, dtypes, shapes and values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _wn(sd, name, arr):
    """Store `arr` under name as a weight-norm pair (name_g, name_v)."""
    g, v = _invert_weight_norm(arr)
    sd[f"{name}_g"], sd[f"{name}_v"] = g, v


def _mapping_args(name: str, rng) -> tuple:
    """Synthetic arguments for from_hf's mapping function `name`, with the
    upstream names and layouts each branch of it reads."""
    if name == "regularize_weight_norm":
        return _r(rng, 8).reshape(8, 1, 1), _r(rng, 8, 4, 3)
    if name == "fold_weight_norms":
        sd = {"conv.bias": _r(rng, 4), "other.weight": _r(rng, 2, 2)}
        _wn(sd, "conv.weight", _r(rng, 4, 2, 3))
        _wn(sd, "lin.weight", _r(rng, 6, 5))
        return (sd,)
    if name == "split_lstm_tensors":
        return "base.lstm", "weight_hh_l1_reverse", _r(rng, 64, 16)
    if name == "split_adain":
        return "blk", "norm2", _r(rng, 64)
    if name == "map_kokoro_albert":
        sd = {n: _r(rng, 4, 4) for n in jhf.ALBERT_PARTS}
        sd.update({jhf.ALBERT_LAYER_PART + n: _r(rng, 4) for n in jhf.ALBERT_PARTS})
        sd["embeddings.token_type_embeddings.weight"] = _r(rng, 2, 4)
        sd["pooler.weight"] = _r(rng, 4, 4)                # not mapped
        return (sd,)
    if name == "map_kokoro_predictor":
        sd = {"text_encoder.lstms.0.weight_ih_l0": _r(rng, 32, 8),
              "text_encoder.lstms.0.bias_hh_l0_reverse": _r(rng, 32),
              "text_encoder.lstms.1.fc.weight": _r(rng, 16, 8),
              "text_encoder.lstms.1.fc.bias": _r(rng, 16),
              "lstm.weight_ih_l0": _r(rng, 32, 8), "shared.weight_hh_l0": _r(rng, 32, 8),
              "F0_proj.weight": _r(rng, 1, 8, 1), "F0_proj.bias": _r(rng, 1),
              "N_proj.weight": _r(rng, 1, 8, 1), "N_proj.bias": _r(rng, 1),
              "duration_proj.linear_layer.weight": _r(rng, 50, 8),
              "duration_proj.linear_layer.bias": _r(rng, 50),
              "N.0.norm1.fc.weight": _r(rng, 16, 8), "N.0.norm1.norm.weight": _r(rng, 8),
              "F0.1.conv1x1.weight": _r(rng, 8, 8, 1), "F0.1.norm2.fc.bias": _r(rng, 16)}
        _wn(sd, "N.0.conv1.weight", _r(rng, 8, 8, 3))
        return (sd,)
    if name == "map_kokoro_decoder":
        sd = {"generator.m_source.l_linear.weight": _r(rng, 1, 9),
              "generator.m_source.l_linear.bias": _r(rng, 1),
              "generator.noise_convs.0.weight": _r(rng, 8, 22, 12),
              "generator.noise_res.0.adain1.0.fc.weight": _r(rng, 16, 4),
              "generator.noise_res.0.adain1.0.norm.weight": _r(rng, 8),
              "generator.noise_res.0.alpha1.0": _r(rng, 1, 8, 1),
              "generator.resblocks.1.adain2.2.fc.bias": _r(rng, 16),
              "generator.resblocks.1.convs2.2.bias": _r(rng, 8),
              "generator.conv_post.bias": _r(rng, 22),
              "decode.0.norm1.fc.weight": _r(rng, 16, 4), "decode.0.conv1x1.weight": _r(rng, 8),
              "encode.norm2.fc.bias": _r(rng, 16), "encode.norm2.norm.bias": _r(rng, 8),
              "F0_conv.weight": _r(rng, 1, 1, 3), "N_conv.bias": _r(rng, 1),
              "asr_res.0.weight": _r(rng, 64, 512, 1), "asr_res.0.bias": _r(rng, 64)}
        _wn(sd, "generator.ups.0.weight", _r(rng, 16, 8, 20))
        _wn(sd, "generator.resblocks.1.convs1.0.weight", _r(rng, 8, 8, 3))
        _wn(sd, "generator.conv_post.weight", _r(rng, 22, 8, 7))
        return (sd,)
    if name == "map_kokoro_text_encoder":
        sd = {"embedding.weight": _r(rng, 10, 8), "cnn.0.0.bias": _r(rng, 8),
              "cnn.0.1.weight": _r(rng, 8), "cnn.2.1.bias": _r(rng, 8),
              "lstm.weight_ih_l0": _r(rng, 16, 8), "lstm.bias_ih_l0_reverse": _r(rng, 16)}
        _wn(sd, "cnn.0.0.weight", _r(rng, 8, 8, 5))
        return (sd,)
    if name == "map_orpheus_llama":
        return ({"model.embed_tokens.weight": _r(rng, 16, 8),
                 "model.layers.0.self_attn.q_proj.weight": _r(rng, 8, 8),
                 "model.layers.0.mlp.down_proj.weight": _r(rng, 8, 16),
                 "model.layers.0.self_attn.rotary_emb.inv_freq": _r(rng, 4),
                 "model.norm.weight": _r(rng, 8), "lm_head.weight": _r(rng, 16, 8)},)
    if name == "llama3_rope_factors":
        return 128, 500000.0, {"factor": 32.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192}
    if name == "simplify_snac_name":
        return ("6.alpha",)      # the other names go through map_snac below
    if name == "fold_parametrizations":
        v = _r(rng, 6, 4, 3)
        g, _ = _invert_weight_norm(v)
        return ({"conv.parametrizations.weight.original0": g,
                 "conv.parametrizations.weight.original1": v, "conv.bias": _r(rng, 6),
                 "conv.parametrizations.bias.original": _r(rng, 6)},)
    if name == "map_snac":
        dec = {"0.bias": _r(rng, 8), "1.bias": _r(rng, 8), "6.alpha": _r(rng, 1, 4, 1),
               "7.bias": _r(rng, 1), "2.block.0.alpha": _r(rng, 1, 8, 1),
               "2.block.1.bias": _r(rng, 4), "2.block.2.linear.weight": _r(rng, 4, 4, 1),
               "2.block.3.block.0.alpha": _r(rng, 1, 4, 1),
               "3.block.5.block.3.bias": _r(rng, 4), "3.block.4.block.9.weight": _r(rng, 4)}
        for n, shape in (("0.", (8, 1, 7)), ("1.", (8, 8, 1)), ("7.", (1, 4, 7)),
                         ("2.block.1.", (8, 4, 16)), ("3.block.5.block.1.", (4, 4, 7))):
            w = _r(rng, *shape)
            g, _ = _invert_weight_norm(w)
            dec[f"{n}parametrizations.weight.original0"] = g
            dec[f"{n}parametrizations.weight.original1"] = w
        qnt = {"quantizers.0.codebook.weight": _r(rng, 32, 8),
               "quantizers.0.out_proj.bias": _r(rng, 8)}
        w = _r(rng, 8, 8, 1)
        g, _ = _invert_weight_norm(w)
        qnt["quantizers.0.out_proj.parametrizations.weight.original0"] = g
        qnt["quantizers.0.out_proj.parametrizations.weight.original1"] = w
        return dec, qnt
    if name == "map_dac":
        sd = _dac_torch_sd("", rng)
        dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
        qnt = {k[len("quantizer."):]: v for k, v in sd.items() if k.startswith("quantizer.")}
        dec["model.7.weight"] = _r(rng, 4)               # not in the decoder's table
        return dec, qnt
    if name == "map_parler_decoder":
        return ({"embed_prompts.weight": _r(rng, 12, 8),
                 "decoder.lm_heads.0.weight": _r(rng, 20, 8),
                 "decoder.lm_heads.8.weight": _r(rng, 20, 8),
                 "decoder.model.decoder.embed_positions.weights": _r(rng, 32, 8),
                 "decoder.model.decoder.layers.0.fc1.weight": _r(rng, 16, 8),
                 "decoder.model.decoder.layer_norm.bias": _r(rng, 8),
                 "text_encoder.shared.weight": _r(rng, 12, 8)},)
    if name == "map_dia":
        sd = {"encoder.embedding.weight": _r(rng, 256, 8), "encoder.norm.weight": _r(rng, 8),
              "decoder.embeddings.3.weight": _r(rng, 1028, 8),
              "decoder.logits_dense.weight": _r(rng, 8, 9, 1028),
              "encoder.layers.0.self_attention.q_proj.weight": _r(rng, 8, 2, 4),
              "encoder.layers.0.self_attention.o_proj.weight": _r(rng, 2, 4, 8),
              "decoder.layers.1.self_attention.k_proj.weight": _r(rng, 8, 1, 4),
              "decoder.layers.1.cross_attention.v_proj.weight": _r(rng, 8, 2, 4),
              "decoder.layers.1.cross_attention.o_proj.weight": _r(rng, 2, 4, 8),
              "decoder.layers.1.mlp.wi_fused.weight": _r(rng, 8, 2, 16),
              "decoder.layers.1.mlp.wo.weight": _r(rng, 16, 8),
              "decoder.layers.1.pre_ca_norm.weight": _r(rng, 8),
              "audio.weight": _r(rng, 4)}                # neither side: skipped
        return (sd,)
    if name == "map_t5_encoder":
        sd = {"shared.weight": _r(rng, 12, 8), "encoder.final_layer_norm.weight": _r(rng, 8),
              "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
                  _r(rng, 32, 2)}
        for i in range(2):
            H = f"encoder.block.{i}.layer"
            for p in ("q", "k", "v", "o"):
                sd[f"{H}.0.SelfAttention.{p}.weight"] = _r(rng, 8, 8)
            sd[f"{H}.0.layer_norm.weight"] = _r(rng, 8)
            sd[f"{H}.1.DenseReluDense.wi_0.weight"] = _r(rng, 16, 8)
            sd[f"{H}.1.DenseReluDense.wi_1.weight"] = _r(rng, 16, 8)
            sd[f"{H}.1.DenseReluDense.wo.weight"] = _r(rng, 8, 16)
            sd[f"{H}.1.layer_norm.weight"] = _r(rng, 8)
        return (sd,)
    raise ValueError(name)


MAPPINGS = ["regularize_weight_norm", "fold_weight_norms", "split_lstm_tensors", "split_adain",
            "map_kokoro_albert", "map_kokoro_predictor", "map_kokoro_decoder",
            "map_kokoro_text_encoder", "map_orpheus_llama", "llama3_rope_factors",
            "simplify_snac_name", "fold_parametrizations", "map_snac", "map_dac",
            "map_parler_decoder", "map_dia", "map_t5_encoder"]


@pytest.mark.parametrize("name", MAPPINGS)
def test_mapping_matches_jax(name):
    args = _mapping_args(name, np.random.default_rng(MAPPINGS.index(name)))
    got, want = getattr(thf, name)(*args), getattr(jhf, name)(*args)
    assert same(got, want), name
    assert (len(got) if isinstance(got, (dict, np.ndarray)) else got)


def test_tables_match_jax():
    for table in ("ALBERT_PARTS", "ALBERT_LAYER_PART", "SNAC_RESIDUAL_UNIT_PARTS",
                  "DAC_DECODER_PARTS", "DAC_DECODER_BLOCK_PARTS", "DAC_RESIDUAL_UNIT_PARTS"):
        assert getattr(thf, table) == getattr(jhf, table), table
    names = ["6.alpha", "7.weight", "0.bias", "1.weight", "4.block.0.alpha",
             "4.block.1.weight", "4.block.2.bias", "5.block.3.block.1.weight",
             "5.block.5.block.3.bias", "5.block.4.block.7.weight"]
    assert [thf.simplify_snac_name(n) for n in names] == [jhf.simplify_snac_name(n)
                                                         for n in names]


# ----------------------------------------------------------- checkpoints ---
def _parler_checkpoint(root) -> str:
    """tests/test_from_hf_cli.py's synthetic Parler checkpoint: the JAX
    builder's decoder and DAC under their raw HF names, a tiny T5 text
    encoder, config.json and a unigram tokenizer.json."""
    from tts_tpu.convert.builder_parler import build_parler_tensors
    from tts_tpu.convert.builder_t5 import build_t5_tensors

    ours, kv = build_parler_tensors(np.random.default_rng(0))
    sd = {}
    for name, arr in ours.items():
        if name.startswith("audio_encoder.") or name == "decoder.text_encoding":
            continue
        if name == "decoder.embed_prompts":
            sd["embed_prompts.weight"] = arr
        elif name == "decoder.positional_embed":
            sd["decoder.model.decoder.embed_positions.weights"] = arr
        elif name.startswith("decoder.lm_heads."):
            sd[f"decoder.lm_heads.{name.split('.')[2]}.weight"] = arr
        else:
            sd[f"decoder.model.decoder.{name[len('decoder.'):]}"] = arr
    sd.update(_dac_torch_sd("audio_encoder.model.", np.random.default_rng(1)))
    t5, _ = build_t5_tensors(np.random.default_rng(2), hidden=64, heads=1, out_size=64)
    inv = {"t5encoder.token_embd": "shared.weight",
           "t5encoder.enc.final_layer_norm": "encoder.final_layer_norm.weight",
           "t5encoder.enc.blk.0.attn_rel_b":
               "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"}
    for i in range(2):
        L, H = f"t5encoder.enc.blk.{i}", f"encoder.block.{i}.layer"
        inv.update({f"{L}.attn_{p}": f"{H}.0.SelfAttention.{p}.weight" for p in "qkvo"})
        inv.update({f"{L}.attn_norm": f"{H}.0.layer_norm.weight",
                    f"{L}.ffn_up": f"{H}.1.DenseReluDense.wi_0.weight",
                    f"{L}.ffn_gate": f"{H}.1.DenseReluDense.wi_1.weight",
                    f"{L}.ffn_down": f"{H}.1.DenseReluDense.wo.weight",
                    f"{L}.ffn_norm": f"{H}.1.layer_norm.weight"})
    for ours_name, hf_name in inv.items():
        sd[f"text_encoder.{hf_name}"] = t5[ours_name]
    ckpt = os.path.join(root, "parler_ckpt")
    os.makedirs(ckpt)
    torch.save({k: torch.tensor(v) for k, v in sd.items()},
               os.path.join(ckpt, "pytorch_model.bin"))
    config = {"decoder": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
                          "num_codebooks": 9, "vocab_size": 1088,
                          "max_position_embeddings": 512, "bos_token_id": 1025,
                          "eos_token_id": 1024},
              "audio_encoder": {"codebook_size": 1024},
              "text_encoder": {"num_layers": 2, "d_model": 64, "num_heads": 1,
                               "vocab_size": 120, "eos_token_id": 1}}
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(ckpt, "tokenizer.json"), "w") as f:
        json.dump({"model": {"type": "Unigram", "unk_id": 0,
                             "vocab": [[t, -1.0] for t in kv["tokenizer.ggml.tokens"]]}}, f)
    return ckpt


def _dia_checkpoint(root) -> tuple[str, str]:
    """tests/test_from_hf_cli.py's synthetic Dia checkpoint (DenseGeneral
    layouts, config.json) and DAC checkpoint."""
    from tts_tpu.convert.builder_dia import build_dia_tensors

    ours, _ = build_dia_tensors(np.random.default_rng(3))
    hs, sd = 16, {}
    sd["encoder.embedding.weight"] = ours["dia.encoder.embedding"]
    for i in range(9):
        sd[f"decoder.embeddings.{i}.weight"] = ours[f"dia.decoder.embeddings.{i}"]
    sd["decoder.logits_dense.weight"] = np.stack([ours[f"dia.decoder.heads.{i}"].T
                                                  for i in range(9)], axis=1)
    for side, hidden in (("encoder", 32), ("decoder", 64)):
        base = f"dia.{side}"
        sd[f"{side}.norm.weight"] = ours[f"{base}.norm"]
        pre = "self_" if side == "decoder" else ""
        for i in range(2):
            L, t = f"{base}.layers.{i}", f"{side}.layers.{i}"
            for p in "qkv":
                sd[f"{t}.self_attention.{p}_proj.weight"] = \
                    ours[f"{L}.{pre}{p}_proj"].T.reshape(hidden, -1, hs)
            sd[f"{t}.self_attention.o_proj.weight"] = \
                ours[f"{L}.{pre}o_proj"].T.reshape(-1, hs, hidden)
            if side == "decoder":
                for p in "qkv":
                    src = hidden if p == "q" else 32
                    sd[f"{t}.cross_attention.{p}_proj.weight"] = \
                        ours[f"{L}.cross_{p}_proj"].T.reshape(src, -1, hs)
                sd[f"{t}.cross_attention.o_proj.weight"] = \
                    ours[f"{L}.cross_o_proj"].T.reshape(-1, hs, hidden)
                for n in ("pre_sa_norm", "pre_ca_norm", "pre_mlp_norm"):
                    sd[f"{t}.{n}.weight"] = ours[f"{L}.{n}"]
            else:
                for n in ("pre_sa_norm", "post_sa_norm"):
                    sd[f"{t}.{n}.weight"] = ours[f"{L}.{n}"]
            sd[f"{t}.mlp.wi_fused.weight"] = np.stack([ours[f"{L}.gate"].T, ours[f"{L}.up"].T],
                                                      axis=1)
            sd[f"{t}.mlp.wo.weight"] = ours[f"{L}.wo"].T
    ckpt = os.path.join(root, "dia_ckpt")
    os.makedirs(ckpt)
    torch.save({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
               os.path.join(ckpt, "dia.pth"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump({"encoder_config": {"n_layer": 2, "n_embd": 32, "n_head": 4, "head_dim": 16,
                                      "max_position_embeddings": 128},
                   "decoder_config": {"n_layer": 2, "n_embd": 64, "gqa_query_heads": 4,
                                      "kv_heads": 2}}, f)
    dac = os.path.join(root, "dac.pth")
    torch.save({k: torch.tensor(v) for k, v in _dac_torch_sd("", np.random.default_rng(4)).items()},
               dac)
    return ckpt, dac


def _convert(which: str, root, argv) -> dict:
    """{package: (output path, stdout)} of both packages' from_hf.main."""
    out = {}
    for name, main, extra in (("jax", jhf.main, []),
                              ("port", thf.main, ["--device", "cpu"] if which == "parler"
                               else [])):
        path = os.path.join(root, f"{which}_{name}.gguf")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([which, *argv, "--out", path, *extra])
        out[name] = (path, buf.getvalue().replace(path, "<out>"))
    return out


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("from_hf"))
    ckpt, dac = _dia_checkpoint(root)
    files = {"dia": _convert("dia", root, ["--repo", ckpt, "--dac-path", dac])}
    files["parler"] = _convert("parler", root, ["--repo", _parler_checkpoint(root),
                                                "--conditional-prompt", "calm voice"])
    return files


def test_convert_dia_is_byte_identical_to_jax(converted):
    (port, port_out), (jax, jax_out) = converted["dia"]["port"], converted["dia"]["jax"]
    assert port_out == jax_out and port_out.startswith("wrote <out> (")
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()


def test_convert_parler_matches_jax_but_the_text_encoding(converted):
    """Every kv and tensor byte-identical to JAX's but decoder.text_encoding,
    the T5 encoding of the prompt, which agrees to TEXT_ENCODING_TOL of its
    peak (the CPU gives ~1e-7)."""
    (port, port_out), (jax, jax_out) = converted["parler"]["port"], converted["parler"]["jax"]
    assert port_out == jax_out
    assert os.path.getsize(port) == os.path.getsize(jax)
    with GGUFFile(port) as a, GGUFFile(jax) as b:
        assert list(a.kv) == list(b.kv)
        for k in a.kv:
            assert same(np.asarray(a.kv[k]) if isinstance(a.kv[k], np.ndarray) else a.kv[k],
                        np.asarray(b.kv[k]) if isinstance(b.kv[k], np.ndarray) else b.kv[k]), k
        assert [(t.name, t.dims, t.ggml_type) for t in a.tensors.values()] == \
            [(t.name, t.dims, t.ggml_type) for t in b.tensors.values()]
        for name in a.tensors:
            if name != "decoder.text_encoding":
                assert np.array_equal(a.tensors[name].raw(), b.tensors[name].raw()), name
        got = a.tensors["decoder.text_encoding"].to_numpy()
        want = b.tensors["decoder.text_encoding"].to_numpy()
        assert got.shape == want.shape and got.shape[0] == a.kv["parler-tts.decoder.encode_length"]
        assert np.abs(got - want).max() <= TEXT_ENCODING_TOL * np.abs(want).max()


@pytest.mark.parametrize("which,text,max_tokens", [("parler", "hello", 16),
                                                   ("dia", "[S1] hi.", 24)])
def test_converted_file_generates_in_the_port(converted, which, text, max_tokens):
    runner = runner_from_file(converted[which]["port"][0], device="cpu")
    resp = runner.generate(text, GenerationConfig(seed=0, max_tokens=max_tokens, sample=False))
    assert np.isfinite(resp.audio).all() and len(resp.audio) > 0
    assert resp.timings["decode_steps"] > 0


def test_convert_cli_refuses_as_jax(tmp_path):
    """dia without --dac-path and the t5 choice exit with JAX's message."""
    for argv in (["dia", "--repo", "r", "--out", str(tmp_path / "o.gguf")],
                 ["t5", "--repo", "r", "--out", str(tmp_path / "o.gguf")]):
        messages = []
        for main in (jhf.main, thf.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            messages.append(str(e.value))
        assert messages[0] == messages[1] and messages[1]


# ---------------------------------------------------- phonemizer trainer ---
def _harvard_lexicon() -> dict:
    """The words of the Harvard sentences with a made-up but consistent IPA:
    letter sounds, "th" as one sound, a silent final "e" and "x" as two
    sounds, so alignments take chunks of 0, 1 and 2 characters."""
    from tts_tpu_torch.apps.perf_battery import HARVARD_SENTENCES

    sounds = {"a": "æ", "c": "k", "e": "ɛ", "i": "ɪ", "j": "dʒ", "o": "ɑ", "q": "k", "u": "ʌ",
              "x": "ks", "y": "j"}
    lexicon = {}
    for word in sorted({w.strip(".,'!?").lower() for s in HARVARD_SENTENCES for w in s.split()}):
        if not word.isalpha():
            continue
        body = word[:-1] if len(word) > 3 and word.endswith("e") else word
        lexicon[word] = "".join(sounds.get(c, c) for c in body.replace("th", "θ"))
    return lexicon


LEXICONS = {"toy": LEXICON, "harvard": None}


@pytest.mark.parametrize("lexicon", list(LEXICONS))
def test_trainer_matches_jax(lexicon, tmp_path):
    """The same stats, rules, exceptions and tables, and a byte-identical
    exported GGUF."""
    lex = LEXICONS[lexicon] or _harvard_lexicon()
    trained = []
    for module in (jtrainer, ttrainer):
        tr = module.PhonemizerTrainer()
        stats = tr.train(lex)
        path = tmp_path / f"{module.__name__.split('.')[0]}.gguf"
        tr.export_gguf(str(path))
        trained.append((stats, tr.rules, tr.exceptions, tr.export_tables(), path.read_bytes()))
    assert trained[1][:4] == trained[0][:4]
    assert trained[1][4] == trained[0][4]
    stats = trained[1][0]
    assert stats["covered"] == stats["words"] == len(lex)


def test_trained_phonemizer_reproduces_the_lexicon(tmp_path):
    from tts_tpu_torch.text.phonemizer import Phonemizer

    tr = ttrainer.PhonemizerTrainer()
    tr.train(LEXICON)
    tr.export_gguf(str(tmp_path / "ph.gguf"))
    with GGUFFile(str(tmp_path / "ph.gguf")) as f:
        assert f.architecture == "phonemizer"
        ph = Phonemizer.from_gguf_kv(f.kv)
    for word, ipa in LEXICON.items():
        assert ph.text_to_phonemes(word) == ipa == tr.build_phonemizer().text_to_phonemes(word)
    assert tr.build_word_phonemizer().phonemize("bab") == "bæb"


@pytest.mark.parametrize("graphemes,phonemes", [("cat", "kɑt"), ("tact", "tækt"),
                                                ("ab", "æbkkkkkkkkkk"), ("thumb", "θʌm")])
def test_align_word_matches_jax(graphemes, phonemes):
    def score(g, c):
        return {0: -2.0, 1: 0.0, 2: -0.2}.get(len(c), -1.0) + (g == c)
    assert ttrainer.align_word(list(graphemes), phonemes, score) == \
        jtrainer.align_word(list(graphemes), phonemes, score)


def test_trainer_cli_matches_jax(tmp_path):
    lex = tmp_path / "lex.json"
    lex.write_text(json.dumps(LEXICON))
    outs = []
    for module in (jtrainer, ttrainer):
        path = tmp_path / f"{module.__name__.split('.')[0]}.gguf"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(["--lexicon", str(lex), "--out", str(path), "--iterations", "2"])
        outs.append((buf.getvalue(), path.read_bytes()))
    assert outs[1] == outs[0]
    assert json.loads(outs[1][0])["covered"] == len(LEXICON)
