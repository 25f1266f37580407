"""The port's own host-side modules against their JAX-package counterparts:
the GGUF reader and writer (tts_tpu_torch.core), the unigram, BPE and
single-pass tokenizers, Kokoro's phonemizer, espeak binding and GGUF
builder, the Parler, T5 and DAC builders, the WAV and AIFF encoders, and
the speech server (on test:dummy and on a tiny Kokoro), each given the same
inputs."""

import ctypes.util
import json
import random
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent where only the port runs

from tts_tpu.apps import server as jserver  # noqa: E402
from tts_tpu.convert import builder_codecs as jcodecs  # noqa: E402
from tts_tpu.convert import builder_dia as jdia  # noqa: E402
from tts_tpu.convert import builder_kokoro as jbuilder  # noqa: E402
from tts_tpu.convert import builder_parler as jparler  # noqa: E402
from tts_tpu.convert import builder_t5 as jt5  # noqa: E402
from tts_tpu.core import gguf as jgguf  # noqa: E402
from tts_tpu.runtime.api import GenerationConfig as JaxGenerationConfig  # noqa: E402
from tts_tpu.runtime.api import TTSError as JaxTTSError  # noqa: E402
from tts_tpu.text import espeak as jespeak  # noqa: E402
from tts_tpu.text import phonemizer as jphonemizer  # noqa: E402
from tts_tpu.text.tokenizers import BPETokenizer as JaxBPETokenizer  # noqa: E402
from tts_tpu.text.tokenizers import SinglePassTokenizer as JaxSinglePassTokenizer  # noqa: E402
from tts_tpu.text.tokenizers import UnigramTokenizer as JaxUnigramTokenizer  # noqa: E402
from tts_tpu.utils import audio as jaudio  # noqa: E402
from tts_tpu_torch.apps import server as tserver  # noqa: E402
from tts_tpu_torch.convert import builder_codecs as tcodecs  # noqa: E402
from tts_tpu_torch.convert import builder_dia as tdia  # noqa: E402
from tts_tpu_torch.convert import builder_kokoro as tbuilder  # noqa: E402
from tts_tpu_torch.convert import builder_parler as tparler  # noqa: E402
from tts_tpu_torch.convert import builder_t5 as tt5  # noqa: E402
from tts_tpu_torch.convert.builder_orpheus import orpheus_kv  # noqa: E402
from tts_tpu_torch.core import gguf as tgguf  # noqa: E402
from tts_tpu_torch.runtime.api import GenerationConfig, TTSError  # noqa: E402
from tts_tpu_torch.text import espeak as tespeak  # noqa: E402
from tts_tpu_torch.text import phonemizer as tphonemizer  # noqa: E402
from tts_tpu_torch.text.tokenizers import (BPETokenizer, SinglePassTokenizer,  # noqa: E402
                                           UnigramTokenizer)
from tts_tpu_torch.utils import audio as taudio  # noqa: E402

TENSOR_TYPES = ["F32", "F16", "BF16", "Q8_0", "Q5_0", "Q4_0"]
KV = {"general.architecture": "orpheus", "u32": 7, "i64": -3, "big": 2**40, "f32": 0.25,
      "flag": True, "name": "tts", "strings": ["a", "Ġb", "ü"], "floats": [0.5, -1.5],
      "ints": [1, 2, 3], "i32s": np.arange(4, dtype=np.int32),
      "f32s": np.linspace(0, 1, 5, dtype=np.float32), "u32s": np.arange(3, dtype=np.uint32),
      "i64s": np.arange(-2, 2, dtype=np.int64), "f64s": np.array([0.1, 0.2])}
EXPLICIT = [("u8", 200, "UINT8"), ("i8", -5, "INT8"), ("u16", 60000, "UINT16"),
            ("i16", -300, "INT16"), ("f64", 0.125, "FLOAT64"), ("u64", 5, "UINT64")]


def _write(module, path, ggml_type, rng):
    """One GGUF of every kv type and a [64, 96] tensor of `ggml_type`, plus a
    raw pre-quantized Q8_0 tensor, by `module`'s writer."""
    w = module.GGUFWriter(path)
    for k, v in KV.items():
        w.add_kv(k, v)
    for k, v, vtype in EXPLICIT:
        w.add_kv(k, v, module.GGUFValueType[vtype])
    arr = rng.standard_normal((64, 96)).astype(np.float32)
    w.add_tensor("w", arr, module.GGMLType[ggml_type])
    w.add_tensor("bias", arr[0].astype(np.float16))
    w.add_tensor("ids", np.arange(5, dtype=np.int32))
    raw = np.frombuffer(module.quant.quantize_q8_0(arr[:2]), np.uint8)
    w.add_raw_tensor("raw", (96, 2), module.GGMLType.Q8_0, raw)
    w.write()
    return path


@pytest.mark.parametrize("ggml_type", TENSOR_TYPES)
def test_gguf_reader_reads_what_jax_wrote(tmp_path, ggml_type):
    """Tensor for tensor (raw bytes, dequantized values, int8 views) and key
    for key, the port's reader sees the file as the JAX package's does."""
    path = _write(jgguf, tmp_path / "m.gguf", ggml_type, np.random.default_rng(0))
    with jgguf.GGUFFile(path) as want, tgguf.GGUFFile(path) as got:
        assert got.architecture == want.architecture == "orpheus"
        assert got.kv.keys() == want.kv.keys()
        for k, v in want.kv.items():
            np.testing.assert_array_equal(np.asarray(got.kv[k]), np.asarray(v), err_msg=k)
            assert type(got.kv[k]) is type(v)
        assert list(got.tensors) == list(want.tensors)
        for name, wt in want.tensors.items():
            gt = got.tensors[name]
            assert (gt.shape, gt.dims, int(gt.ggml_type)) == (wt.shape, wt.dims, int(wt.ggml_type))
            np.testing.assert_array_equal(gt.raw(), wt.raw())
            np.testing.assert_array_equal(gt.to_numpy(), wt.to_numpy())
            if wt.ggml_type.name in ("Q8_0", "Q5_0", "Q4_0"):
                for a, b in zip(gt.to_int8_scales(), wt.to_int8_scales()):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ggml_type", TENSOR_TYPES)
def test_gguf_writer_is_byte_identical(tmp_path, ggml_type):
    want = _write(jgguf, tmp_path / "jax.gguf", ggml_type, np.random.default_rng(1))
    got = _write(tgguf, tmp_path / "port.gguf", ggml_type, np.random.default_rng(1))
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("text", ["hello", "hi there, zoe", "a  b   c", "naïve café!", ""])
def test_bpe_tokenizer_gives_jax_ids(text):
    kv = orpheus_kv(1, 64, 1, 1, 64, 300)
    kv["tokenizer.ggml.tokens"] += ["th", "the", "Ġth", "Ġthe", "er", "ere"]
    kv["tokenizer.ggml.merges"] += ["t h", "th e", "Ġ th", "Ġth e", "e r", "er e"]
    assert (BPETokenizer.from_gguf_kv(kv).tokenize(text)
            == JaxBPETokenizer.from_gguf_kv(kv).tokenize(text))


UNIGRAM_TEXTS = ["hello world", "the  cat   sat", "", "naïve café!", "ab\u2581cd", "zzz 123 ?",
                 "a calm female voice, close up"]


@pytest.mark.parametrize("text", UNIGRAM_TEXTS)
def test_unigram_tokenizer_gives_jax_ids(text):
    """Parler's tokenizer: the tiny builder vocabulary (chars, space, unk;
    every byte outside it an unknown, consecutive unknowns merged), and one
    with multi-character pieces, scores that prefer them and a SentencePiece
    '\u2581' piece, with and without space deduplication."""
    kv = tparler.unigram_kv(40)
    kv["tokenizer.ggml.tokens"] = kv["tokenizer.ggml.tokens"] + ["\u2581the", "he", "ll", "cat"]
    kv["tokenizer.ggml.scores"] = np.concatenate([kv["tokenizer.ggml.scores"],
                                                  np.float32([-0.5, -1.2, -1.5, -0.1])])
    for vocab in (tparler.unigram_kv(120), kv):
        got, want = UnigramTokenizer.from_gguf_kv(vocab), JaxUnigramTokenizer.from_gguf_kv(vocab)
        assert got.tokenize(text) == want.tokenize(text)
        got.dedupe_spaces = want.dedupe_spaces = False
        assert got.tokenize(text) == want.tokenize(text)


@pytest.mark.parametrize("kwargs", [{}, dict(n_layers=2, hidden=256, heads=4, ffn=512)],
                         ids=["default", "tiny"])
def test_parler_builder_is_byte_identical(tmp_path, kwargs):
    want = jparler.write_parler_gguf(tmp_path / "jax.gguf", seed=4, **kwargs)
    got = tparler.write_parler_gguf(tmp_path / "port.gguf", seed=4, **kwargs)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("kwargs", [{}, dict(enc_layers=1, dec_layers=2, enc_hidden=256,
                                             dec_hidden=256, enc_heads=4, dec_heads=4,
                                             query_heads=2, head_size=128, ffn=512)],
                         ids=["default", "tiny"])
def test_dia_builder_is_byte_identical(tmp_path, kwargs):
    want = jdia.write_dia_gguf(str(tmp_path / "jax.gguf"), seed=5, **kwargs)
    got = tdia.write_dia_gguf(str(tmp_path / "port.gguf"), seed=5, **kwargs)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kwargs", [{}, dict(out_size=32, n_layers=1)], ids=["default", "out32"])
def test_t5_builder_is_byte_identical(tmp_path, kwargs):
    want = jt5.write_t5_gguf(tmp_path / "jax.gguf", seed=2, **kwargs)
    got = tt5.write_t5_gguf(tmp_path / "port.gguf", seed=2, **kwargs)
    assert got.read_bytes() == want.read_bytes()


def test_dac_builder_gives_jax_tensors():
    """build_dac_tensors with its defaults (decoder_dim = channels[0]) draws
    the JAX builder's tensors and metadata; DAC_44KHZ's decoder_dim widens
    only the in-conv's output and block 1's input."""
    want, want_kv = jcodecs.build_dac_tensors(np.random.default_rng(6), latent=32,
                                              channels=(24, 12, 6, 4))
    got, got_kv = tcodecs.build_dac_tensors(np.random.default_rng(6), latent=32,
                                            channels=(24, 12, 6, 4))
    assert got_kv == want_kv and list(got) == list(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    wide, _ = tcodecs.build_dac_tensors(np.random.default_rng(6), latent=32,
                                        channels=(24, 12, 6, 4), decoder_dim=40)
    shapes = {n: a.shape for n, a in wide.items() if a.shape != want[n].shape}
    assert shapes == {"audio_encoder.initial.weight": (40, 32, 7),
                      "audio_encoder.initial.bias": (40,),
                      "audio_encoder.decoder_block.1.final.alpha": (1, 40, 1),
                      "audio_encoder.decoder_block.1.final.weight": (40, 24, 16)}


@pytest.mark.parametrize("fmt", ["wav16", "wav32", "aiff"])
def test_audio_encoders_give_jax_bytes(fmt):
    audio = np.random.default_rng(2).uniform(-1.2, 1.2, 2001).astype(np.float32)
    sr = 24000
    if fmt == "aiff":
        assert taudio.encode_aiff(audio, sr) == jaudio.encode_aiff(audio, sr)
    else:
        bits = int(fmt[3:])
        assert taudio.encode_wav(audio, sr, bits) == jaudio.encode_wav(audio, sr, bits)


@pytest.fixture(scope="module")
def servers():
    """The JAX package's server and the port's, each serving test:dummy on a
    free port; yields {"jax": port, "port": port}."""
    jstate = jserver.ServerState({"dummy": "test:dummy"}, JaxGenerationConfig(), 1)
    tstate = tserver.ServerState({"dummy": "test:dummy"}, GenerationConfig(), 1, device="cpu")
    srvs = {"jax": jserver.ThreadingHTTPServer(("127.0.0.1", 0), jserver.make_handler(jstate)),
            "port": tserver.make_server(tstate, port=0)}
    for s in srvs.values():
        threading.Thread(target=s.serve_forever, daemon=True).start()
    yield {k: s.server_address[1] for k, s in srvs.items()}
    for s in srvs.values():
        s.shutdown()
        s.server_close()
    tserver.stop_workers(tstate)


def _call(port, method, path, payload):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("method,path,payload", [
    ("POST", "/v1/audio/speech", {"input": "ab"}),
    ("POST", "/v1/audio/speech", {"input": "a", "response_format": "aiff"}),
    ("POST", "/v1/audio/speech", {"input": "ab", "response_format": "pcm"}),
    ("POST", "/v1/audio/speech", {}),
    ("POST", "/v1/audio/speech", {"input": ""}),
    ("POST", "/v1/audio/speech", {"input": "a", "response_format": "mp3"}),
    ("POST", "/v1/audio/speech", {"input": "a", "model": "nope"}),
    ("POST", "/v1/audio/speech", {"input": "a", "top_k": "many"}),
    ("POST", "/v1/audio/conditional-prompt", {"prompt": "x", "text_encoder_path": "t"}),
    ("POST", "/nowhere", {}),
    ("GET", "/v1/models", None),
    ("GET", "/v1/audio/voices", None),
    ("GET", "/health", None),
    ("GET", "/", None),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else None)
def test_server_answers_as_jax_server(servers, method, path, payload):
    """Status, content type and body agree: audio byte for byte, error JSON
    key for key."""
    got = _call(servers["port"], method, path, payload)
    want = _call(servers["jax"], method, path, payload)
    assert got[:2] == want[:2]
    if want[1] == "application/json":
        assert json.loads(got[2]) == json.loads(want[2])
    else:
        assert got[2] == want[2]


# --------------------------------------------------------------- Kokoro ---

def _fuzz(n, seed=0):
    """Seeded random strings over letters, digits, punctuation, accents,
    IPA and symbols (as tests/test_phonemizer.py's fuzz test draws)."""
    rng = random.Random(seed)
    alphabet = ("abc XYZ 0123456789 .,!?;:'\"-()[]{} $%&*+<>= \t\n"
                "éüñ ʃʒθð ... -- '' ½¾ MCMXCIV I.B.M. o'clock 1,234.56")
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40))) for _ in range(n)]


PHONEMIZER_TEXTS = [
    "The birch canoe slid on the smooth planks.", "It's easy to tell the depth of a well.",
    "Four hours of steady work faced us.", "hello, world!", "the cat 42", "3.14", "32,000",
    "1,000,000,000,000,001", "the HTML", "U.S.", "HELLO WORLD", "chapter XIV", "dog's",
    "boss's tree's", "they're", "cat + dog", "twenty-one", "café naïve", "dr. who", "",
    "   ", "-5 1-2 .3 3.",
] + _fuzz(8)


def _phonemizers(module):
    """A phonemizer from the tiny Kokoro GGUF's tables, and one with a
    richer dictionary and per-letter rules (tests/test_phonemizer.py's)."""
    _, kv = jbuilder.build_kokoro_tensors(jbuilder.KokoroDims.tiny(), np.random.default_rng(0))
    d = module.PhonemeDictionary()
    for word, ph in (("hello", "həlˈoʊ"), ("world", "wˈɜːld"), ("the", "ðə"), ("cat", "kˈæt"),
                     ("dog", "dˈɑːɡ"), ("they", "ðˈeɪ"), ("tree", "tɹˈiː"), ("boss", "bˈɑːs"),
                     ("twenty", "twˈɛnti"), ("one", "wˈʌn"), ("dr", "dˈɑːktɚ:.")):
        d.add(word, ph)
    wp = module.WordPhonemizer(module.SinglePassTokenizer(list("abcdefghijklmnopqrstuvwxyz")))
    for ch in "abcdefghijklmnopqrstuvwxyz":
        wp.add_rule([ch], ch.upper())
    return module.Phonemizer.from_gguf_kv(kv), module.Phonemizer(d, wp)


@pytest.mark.parametrize("text", PHONEMIZER_TEXTS, ids=range(len(PHONEMIZER_TEXTS)))
def test_phonemizer_gives_jax_phonemes(text):
    for got, want in zip(_phonemizers(tphonemizer), _phonemizers(jphonemizer)):
        assert got.text_to_phonemes(text) == want.text_to_phonemes(text)


@pytest.mark.parametrize("text", ["hɛlo wɝld", "ðə kˈæt", "naïve 🎉 ab", "", "abcabc  x"])
def test_single_pass_tokenizer_gives_jax_ids(text):
    """Kokoro's char vocabulary (shortest match, unknown bytes -> 0) and the
    phonemizer's graphemes (longest match)."""
    vocab = ["", "a", "b", "ab", "abc", " ", "ð", "ə", "ˈ", "æ", "k", "t", "ɛ", "🎉", "x"]
    got, want = SinglePassTokenizer(vocab), JaxSinglePassTokenizer(vocab)
    assert got.tokenize(text) == want.tokenize(text)
    assert got.token_split(text) == want.token_split(text)


@pytest.mark.parametrize("bias", [None, -2.6])
def test_kokoro_builder_is_byte_identical(tmp_path, bias):
    dims = jbuilder.KokoroDims.tiny()
    want = jbuilder.write_kokoro_gguf(tmp_path / "jax.gguf", dims, seed=3, duration_bias=bias)
    got = tbuilder.write_kokoro_gguf(tmp_path / "port.gguf", dims, seed=3, duration_bias=bias)
    assert got.read_bytes() == want.read_bytes()
    assert tbuilder.KokoroDims.kokoro_82m() == tbuilder.KokoroDims()


def test_espeak_raises_tts_error_without_the_library(monkeypatch):
    """Only the missing-library path can be tested: libespeak-ng is not
    installed where these tests run, nor (as far as is known) on the card's
    machine.  find_library is stubbed so the test means the same anywhere."""
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    for module in (tespeak, jespeak):
        monkeypatch.setattr(module, "_lib", None)
    assert not tespeak.available() and not jespeak.available()
    with pytest.raises(JaxTTSError) as want:
        jespeak.espeak_text_to_phonemes("hello")
    with pytest.raises(TTSError) as got:
        tespeak.espeak_text_to_phonemes("hello")
    assert str(got.value) == str(want.value)
    ph = tphonemizer.Phonemizer.from_gguf_kv({"phonemizer.type": 1}, espeak_voice="gmw/en")
    assert ph.mode == "espeak"
    with pytest.raises(TTSError, match="espeak-ng is not installed"):
        ph.text_to_phonemes("hello")


@pytest.fixture(scope="module")
def kokoro_servers(tmp_path_factory):
    """Both packages' servers on one tiny Kokoro GGUF (the port's on the
    CPU); yields {"jax": port, "port": port}."""
    path = str(jbuilder.write_kokoro_gguf(tmp_path_factory.mktemp("kokoro") / "k.gguf",
                                          jbuilder.KokoroDims.tiny(), seed=0,
                                          duration_bias=-2.6))
    jstate = jserver.ServerState({"kokoro": path}, JaxGenerationConfig(), 1)
    tstate = tserver.ServerState({"kokoro": path}, GenerationConfig(), 1, device="cpu")
    srvs = {"jax": jserver.ThreadingHTTPServer(("127.0.0.1", 0), jserver.make_handler(jstate)),
            "port": tserver.make_server(tstate, port=0)}
    for srv in srvs.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield {k: srv.server_address[1] for k, srv in srvs.items()}
    for srv in srvs.values():
        srv.shutdown()
        srv.server_close()
    tserver.stop_workers(tstate)


@pytest.mark.parametrize("method,path,payload", [
    ("POST", "/v1/audio/speech", {"input": "hello world", "voice": "af_heart", "seed": 1}),
    ("POST", "/v1/audio/speech", {"input": "hello world. and a second clause", "seed": 1,
                                  "response_format": "pcm"}),
    ("POST", "/v1/audio/speech", {"input": "hello world", "voice": "nope"}),
    ("GET", "/v1/audio/voices", None),
    ("GET", "/v1/models", None),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else None)
def test_server_answers_kokoro_as_jax_server(kokoro_servers, method, path, payload):
    """Status, content type and JSON agree; a WAV agrees in its header (rate,
    width, length), a PCM stream (generate_stream's chunks) in its length,
    and neither is silent.  The samples differ: JAX quantizes against the
    peak of a bucketed bf16 run, the port runs exact shapes
    (tests/test_torch_kokoro.py compares the audio in f32)."""
    got = _call(kokoro_servers["port"], method, path, payload)
    want = _call(kokoro_servers["jax"], method, path, payload)
    assert got[:2] == want[:2]
    if want[1] == "application/json":
        assert json.loads(got[2]) == json.loads(want[2])
        return
    header = 44 if want[1] == "audio/wav" else 0
    assert got[2][:header] == want[2][:header] and len(got[2]) == len(want[2]) > header
    assert np.abs(np.frombuffer(got[2][header:], np.int16)).max() > 0
