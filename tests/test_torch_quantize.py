"""The port's quantize app (tts_tpu_torch.apps.quantize) against the JAX
package's: for tiny Kokoro, Orpheus, Parler and Dia GGUFs, each output type
and each flag, the same input gives a byte-identical file and equal stats;
the CLI prints the same line; an unsupported architecture raises the same
error; and quantized files load and generate in the port (on the CPU)."""

import contextlib
import io

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

import torch  # noqa: E402

from torch_tiny import TINY, TINY_DIA, TINY_PARLER  # noqa: E402
from tts_tpu.apps import quantize as jq  # noqa: E402
from tts_tpu.convert.builder_dia import write_dia_gguf  # noqa: E402
from tts_tpu.convert.builder_kokoro import KokoroDims, write_kokoro_gguf  # noqa: E402
from tts_tpu.convert.builder_orpheus import write_orpheus_gguf  # noqa: E402
from tts_tpu.convert.builder_parler import write_parler_gguf  # noqa: E402
from tts_tpu_torch.apps import quantize as tq  # noqa: E402
from tts_tpu_torch.core.gguf import GGMLType, GGUFFile  # noqa: E402
from tts_tpu_torch.models.registry import runner_from_file  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("kokoro", "orpheus", "parler", "dia")
TYPES = ("Q4_0", "Q5_0", "Q8_0", "F16", "BF16")
FLAGS = ("quantize_output_heads", "quantize_text_embeddings", "quantize_cross_attn_kv",
         "convert_dac_to_f16", "convert_non_quantized_to_f16")
# every type on every architecture, then each flag where its rule reads it
# (a thread count apart from the default: the pool must keep job order)
CASES = ([(arch, qtype, None) for arch in ARCHS for qtype in TYPES]
         + [("orpheus", "Q8_0", "quantize_output_heads"),
            ("dia", "Q4_0", "quantize_output_heads"),
            ("parler", "Q4_0", "quantize_output_heads"),
            ("parler", "Q8_0", "quantize_text_embeddings"),
            ("parler", "Q5_0", "quantize_cross_attn_kv"),
            ("parler", "Q8_0", "convert_dac_to_f16"),
            ("orpheus", "Q4_0", "convert_dac_to_f16"),
            ("dia", "F16", "convert_dac_to_f16"),
            ("kokoro", "Q4_0", "convert_non_quantized_to_f16"),
            ("kokoro", "BF16", "convert_non_quantized_to_f16")])
# the CLI's flag of each QuantizationParams field
CLI_FLAGS = {"quantize_output_heads": "--quantize-output-heads",
             "quantize_text_embeddings": "--quantize-text-embedding",
             "quantize_cross_attn_kv": "--quantize-cross-attn-kv",
             "convert_dac_to_f16": "--convert-dac-to-f16",
             "convert_non_quantized_to_f16": "--convert-non-quantized-to-f16"}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """sources(arch) -> path of a tiny f32 GGUF by the JAX package's builder,
    written on first use."""
    root = tmp_path_factory.mktemp("quantize")
    built = {}

    def get(arch):
        if arch not in built:
            path = root / f"{arch}.gguf"
            if arch == "kokoro":
                write_kokoro_gguf(path, KokoroDims.tiny(), seed=0)
            elif arch == "orpheus":
                # a short vocabulary: the file only feeds the quantizer
                write_orpheus_gguf(path, seed=0, hidden=64, head_dim=16, vocab=4096)
            elif arch == "parler":
                write_parler_gguf(path, seed=0, **TINY_PARLER)
            else:
                write_dia_gguf(str(path), seed=0, **TINY_DIA)
            built[arch] = str(path)
        return built[arch]
    return get


def _params(module, qtype, flag, n_threads):
    kw = {flag: True} if flag else {}
    return module.QuantizationParams(module.VALID_TYPES[qtype], n_threads=n_threads, **kw)


def test_valid_types_and_rules_match_jax():
    assert {k: v.name for k, v in tq.VALID_TYPES.items()} == \
        {k: v.name for k, v in jq.VALID_TYPES.items()}
    assert set(tq._QUANTIZABLE) == set(jq._QUANTIZABLE)


@pytest.mark.parametrize("arch,qtype,flag", CASES,
                         ids=[f"{a}-{q}-{f or 'default'}" for a, q, f in CASES])
def test_quantize_is_byte_identical_to_jax(sources, tmp_path, arch, qtype, flag):
    src = sources(arch)
    threads = 8 if flag else 4
    want = jq.quantize_gguf(src, str(tmp_path / "jax.gguf"), _params(jq, qtype, flag, threads))
    got = tq.quantize_gguf(src, str(tmp_path / "port.gguf"), _params(tq, qtype, flag, threads))
    assert got == want
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    assert got["quantized"] + got["f16"] > 0


@pytest.mark.parametrize("qtype,flags", [("Q4_0", ()),
                                         ("Q8_0", ("quantize_output_heads",
                                                   "quantize_cross_attn_kv",
                                                   "convert_dac_to_f16"))])
def test_cli_prints_what_jax_prints(sources, tmp_path, qtype, flags):
    src = sources("parler")
    lines = {}
    for name, module in (("jax", jq), ("port", tq)):
        out = str(tmp_path / f"{name}.gguf")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = module.main(["-mp", src, "-qp", out, "-qt", qtype, "-nt", "2",
                              *(CLI_FLAGS[f] for f in flags)])
        assert rc == 0
        lines[name] = buf.getvalue().replace(out, "<out>")
    assert lines["port"] == lines["jax"]
    assert lines["port"].startswith("quantized=")
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()


def test_unsupported_architecture_raises_as_jax(tmp_path):
    from tts_tpu_torch.convert.phonemizer_trainer import PhonemizerTrainer

    tr = PhonemizerTrainer()
    tr.train({"ab": "æb", "ba": "bæ"})
    src = str(tmp_path / "ph.gguf")
    tr.export_gguf(src)
    errors = []
    for module in (jq, tq):
        with pytest.raises(ValueError) as e:
            module.quantize_gguf(src, str(tmp_path / "out.gguf"), module.QuantizationParams())
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "architecture 'phonemizer' is not supported for quantization"


def test_quantized_kokoro_loads_and_generates(sources, tmp_path):
    out = str(tmp_path / "kokoro_q8.gguf")
    tq.quantize_gguf(sources("kokoro"), out, tq.QuantizationParams(GGMLType.Q8_0))
    with GGUFFile(out) as f:
        assert f.tensors["kokoro.albert.layer.0.q"].ggml_type == GGMLType.Q8_0
    cfg = GenerationConfig(voice="af_heart", seed=0)
    resp = runner_from_file(out, device="cpu").generate("hello", cfg)
    dense = runner_from_file(sources("kokoro"), device="cpu").generate("hello", cfg)
    assert resp.audio.shape == dense.audio.shape and np.isfinite(resp.audio).all()


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_quantized_orpheus_loads_and_generates(tmp_path, qtype):
    """A tiny f32 Orpheus (kernel-eligible widths, the real vocabulary) by the
    port's builder, quantized by the port: every linear packs to the
    format's kernel layout, and a request decodes."""
    from tts_tpu_torch.convert.builder_orpheus import write_orpheus_gguf as write_port_orpheus

    write_port_orpheus(str(tmp_path / "orpheus.gguf"), seed=0, **TINY)
    out = str(tmp_path / "orpheus_q.gguf")
    stats = tq.quantize_gguf(str(tmp_path / "orpheus.gguf"), out,
                             tq.QuantizationParams(GGMLType[qtype], quantize_output_heads=True))
    assert stats["quantized"] == 2 + 7 * TINY["n_layers"]   # embedding, head, 7 per layer
    r = runner_from_file(out, device="cpu")
    key = "wq4" if qtype == "Q4_0" else "wq"
    assert key in r.params["layers"][0]["qkv"] and key in r.params["head"]
    resp = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, top_k=50))
    assert len(resp.audio) == (15 // 7) * 4 * 512 and np.isfinite(resp.audio).all()


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0"])
def test_random_f32_parler_quantizes_loads_and_decodes(tmp_path, qtype):
    """The f32 route of the port's random Parler writer (the chain the card
    runs at full width): quantized by the port's app, every decoder linear
    but the cross-attention k/v (dense by the Parler rule) packs to the
    format's layout, and a request decodes its rows."""
    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler

    dims = dict(PARLER_MINI_V1, **TINY_PARLER, prompt_vocab=64, enc_len=12, enc_hidden=64,
                max_ctx=512, max_gen=64)
    dac = dict(DAC_44KHZ, latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
    src = write_random_parler(tmp_path / "parler_f32.gguf", qtype="F32", dac=dac, **dims)
    with GGUFFile(src) as f:
        assert f.tensors["decoder.layers.0.fc1.weight"].ggml_type == GGMLType.F32
        assert f.tensors["decoder.lm_heads.0.weight.head"].ggml_type == GGMLType.F16
    out = str(tmp_path / "parler_q.gguf")
    stats = tq.quantize_gguf(str(src), out, tq.QuantizationParams(GGMLType[qtype]))
    assert stats["quantized"] == 8 * TINY_PARLER["n_layers"]
    r = runner_from_file(out, device="cpu")
    key = "wq4" if qtype == "Q4_0" else "wq"
    L = r.params["layers"][0]
    assert all(key in L[n] for n in ("sa_q", "sa_k", "sa_v", "sa_o", "ca_q", "ca_o", "fc1",
                                     "fc2"))
    assert "w" in L["ca_k"] and "w" in L["ca_v"]
    resp = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, top_k=50))
    assert resp.timings["decode_steps"] == 15 and resp.timings["frames"] == 15 - 8
    assert len(resp.audio) == 512 * 7 and np.isfinite(resp.audio).all()


def test_quantized_dia_loads_and_generates(sources, tmp_path):
    out = str(tmp_path / "dia_q8.gguf")
    tq.quantize_gguf(sources("dia"), out, tq.QuantizationParams(GGMLType.Q8_0))
    r = runner_from_file(out, device="cpu")
    assert "wq" in r.params["decoder"]["layers"][0]["ca_k"]
    resp = r.generate("[S1] hi.", GenerationConfig(seed=0, max_tokens=24, sample=False))
    assert resp.timings["decode_steps"] == 23 and np.isfinite(resp.audio).all()
