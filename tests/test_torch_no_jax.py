"""The port runs where neither JAX nor the JAX package can be imported: in a
fresh interpreter whose import hook refuses `jax`, `jaxlib` and `tts_tpu`
(and every submodule of them), import each module of tts_tpu_torch, serve
test:dummy through the port's server, then write a tiny Q8_0 or Q4_0
Orpheus, a tiny Kokoro, a tiny Q8_0 or Q4_0 Parler and T5, or a tiny Q8_0
or Q4_0 Dia, with the port's own builders, load it and synthesize on the
CPU: greedy and sampled requests and a stream, for Orpheus a greedy stream
on its speculative route; or write a tiny f32 Parler, quantize it to Q4_0
with the port's quantize app and speak it to a WAV with the port's cli."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "tts_tpu")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Refuse())
    import dataclasses, importlib, json, pkgutil, threading, urllib.request
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import tts_tpu_torch
    from tts_tpu_torch.convert.builder_codecs import DAC_44KHZ
    for m in pkgutil.walk_packages(tts_tpu_torch.__path__, "tts_tpu_torch."):
        importlib.import_module(m.name)
    from torch_tiny import CTX, GEN, TINY
    from tts_tpu_torch.apps.server import ServerState, make_server, stop_workers
    from tts_tpu_torch.convert.builder_orpheus import write_random_orpheus
    from tts_tpu_torch.models.registry import runner_from_file
    from tts_tpu_torch.runtime.api import GenerationConfig

    state = ServerState({"dummy": "test:dummy"}, GenerationConfig(), 1, device="cpu")
    srv = make_server(state, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/speech",
                                 data=json.dumps({"input": "ab"}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        wav = r.read()
    srv.shutdown()
    stop_workers(state)
    print("WAV", r.status, len(wav))

    qtype = sys.argv[2]
    if qtype == "kokoro":
        from tts_tpu_torch.convert.builder_kokoro import KokoroDims, write_kokoro_gguf
        path = write_kokoro_gguf(sys.argv[1], KokoroDims.tiny(), seed=0, duration_bias=-2.6)
        r = runner_from_file(str(path), device="cpu")
        assert r.architecture == "kokoro" and r.list_voices() == ["af_heart"]
        resp = r.generate("hello world", GenerationConfig(voice="af_heart", seed=0))
    elif qtype.startswith("parler"):
        from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler
        from tts_tpu_torch.convert.builder_t5 import write_t5_gguf
        dims = dict(PARLER_MINI_V1, n_layers=2, hidden=256, heads=4, ffn=512, prompt_vocab=64,
                    enc_len=12, enc_hidden=64, max_ctx=512, max_gen=64)
        dac = dict(DAC_44KHZ, latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
        path = write_random_parler(sys.argv[1], qtype=qtype.split("-")[1], dac=dac, **dims)
        t5 = write_t5_gguf(sys.argv[1] + ".t5", out_size=64)
        r = runner_from_file(str(path), device="cpu")
        key = "wq4" if qtype.endswith("Q4_0") else "wq"
        assert r.architecture == "parler-tts" and key in r.params["layers"][0]["ca_k"]
        r.update_conditional_prompt(str(t5), "a calm voice")
        greedy = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, sample=False))
        resp = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, top_k=50))
        stream = np.concatenate(list(r.generate_stream(
            "hi", GenerationConfig(seed=0, max_tokens=15, top_k=50), chunk_steps=4)))
        assert stream.shape == resp.audio.shape and np.allclose(stream, resp.audio, atol=2e-5,
                                                                rtol=0)
        assert len(greedy.audio) == len(resp.audio)
    elif qtype == "apps":
        import contextlib, io
        from tts_tpu_torch.apps import cli, quantize
        from tts_tpu_torch.convert.builder_parler import PARLER_MINI_V1, write_random_parler
        from tts_tpu_torch.utils.audio import encode_wav
        dims = dict(PARLER_MINI_V1, n_layers=2, hidden=256, heads=4, ffn=512, prompt_vocab=64,
                    enc_len=12, enc_hidden=64, max_ctx=512, max_gen=64)
        dac = dict(DAC_44KHZ, latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
        src = write_random_parler(sys.argv[1], qtype="F32", dac=dac, **dims)
        q4, wav = sys.argv[1] + ".q4", sys.argv[1] + ".wav"
        with contextlib.redirect_stdout(io.StringIO()):
            assert quantize.main(["-mp", str(src), "-qp", q4, "-qt", "Q4_0"]) == 0
            assert cli.main(["-mp", q4, "-p", "hi", "-sp", wav, "--max-tokens", "15",
                             "--seed", "0", "--device", "cpu"]) == 0
        r = runner_from_file(q4, device="cpu")
        assert "wq4" in r.params["layers"][0]["fc1"]
        resp = r.generate("hi", GenerationConfig(top_k=50, max_tokens=15, seed=0))
        assert open(wav, "rb").read() == encode_wav(resp.audio, 44100)
    elif qtype.startswith("dia"):
        from tts_tpu_torch.convert.builder_dia import DIA_1_6B, write_random_dia
        dims = dict(DIA_1_6B, enc_layers=2, dec_layers=2, enc_hidden=256, dec_hidden=256,
                    enc_heads=4, dec_heads=4, query_heads=2, enc_ffn=512, ffn=512, enc_ctx=128,
                    max_gen=64)
        dac = dict(DAC_44KHZ, latent=96, decoder_dim=48, channels=(48, 24, 12, 6))
        path = write_random_dia(sys.argv[1], qtype=qtype.split("-")[1], dac=dac, **dims)
        r = runner_from_file(str(path), device="cpu")
        key = "wq4" if qtype.endswith("Q4_0") else "wq"
        assert r.architecture == "dia" and key in r.params["decoder"]["layers"][0]["ca_k"]
        greedy = r.generate("[S1] hi.", GenerationConfig(seed=0, max_tokens=24, sample=False))
        resp = r.generate("[S1] hi.", GenerationConfig(seed=0, max_tokens=24, top_k=50))
        stream = np.concatenate(list(r.generate_stream(
            "[S1] hi.", GenerationConfig(seed=0, max_tokens=24, top_k=50), chunk_steps=5)))
        assert stream.shape == resp.audio.shape and np.allclose(stream, resp.audio, atol=2e-5,
                                                                rtol=0)
        for out in (greedy, resp):
            assert out.timings["decode_steps"] == 23 and 0 < out.timings["frames"] <= 8
            assert len(out.audio) == 512 * out.timings["frames"]
    else:
        from tts_tpu_torch.models import orpheus
        path = write_random_orpheus(sys.argv[1], qtype=qtype.split("-")[-1], **TINY,
                                    vocab=156940, snac_embd=96, snac_channels=(48, 24, 12, 6))
        r = runner_from_file(str(path), device="cpu")
        r.cfg = dataclasses.replace(r.cfg, max_context_length=CTX, max_generation_size=GEN)
        key = "wq4" if qtype.endswith("Q4_0") else "wq"
        assert key in r.params["layers"][0]["qkv"] and key in r.params["head"]
        if qtype.startswith("orpheus-stream"):
            calls = []
            spec = orpheus.orpheus_decode_loop_spec_resume
            orpheus.orpheus_decode_loop_spec_resume = (
                lambda *a, **kw: calls.append(1) or spec(*a, **kw))
            cfg = GenerationConfig(seed=0, max_tokens=15, sample=False)
            stream = np.concatenate(list(r.generate_stream("hi", cfg, chunk_tokens=7)))
            resp = r.generate("hi", cfg)
            # two 7-token chunks after the prefill's token, and generate's call
            assert len(calls) == 3 and stream.shape == resp.audio.shape
            assert np.allclose(stream, resp.audio, atol=2e-5, rtol=0)
        else:
            resp = r.generate("hi", GenerationConfig(seed=0, max_tokens=15, top_k=50))
    loaded = sorted(m for m, v in sys.modules.items()
                    if m.split(".")[0] in BLOCKED and v is not None)
    print("AUDIO", len(resp.audio), bool(np.isfinite(resp.audio).all()), "BLOCKED", loaded)
""")


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_0", "kokoro", "parler-Q8_0", "parler-Q4_0",
                                   "dia-Q8_0", "dia-Q4_0", "orpheus-stream-Q8_0", "apps"])
def test_port_runs_without_jax(tmp_path, qtype):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path / "tiny.gguf"), qtype],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # test:dummy: 2 characters -> 2 s of 44.1 kHz 16-bit audio + a 44-byte header
    assert f"WAV 200 {44 + 2 * 44100 * 2}" in lines, lines
    # Orpheus: 15 tokens -> 2 frames of 4 * 512 samples; Kokoro: "hello
    # world" -> bos, 11 phoneme ids, eos at 3 frames each (sigmoid(-2.6) * 50
    # ~ 3.45 per token) of 600 samples; Parler: 15 rows -> 15 - 8 frames
    # (the delay staircase) of 512 samples, every code an audio code; Dia:
    # 23 rows -> up to 23 - 15 frames of 512 samples (a sampled EOS or PAD
    # drops its frame; the script checks the count)
    if qtype.startswith("dia"):
        audio = [line for line in lines if re.fullmatch(r"AUDIO \d+ True BLOCKED \[\]", line)]
        assert len(audio) == 1 and int(audio[0].split()[1]) % 512 == 0, lines
        return
    n = {"kokoro": 13 * 3 * 600, "parler-Q8_0": 7 * 512, "parler-Q4_0": 7 * 512,
         "apps": 7 * 512}.get(qtype, (15 // 7) * 4 * 512)
    assert f"AUDIO {n} True BLOCKED []" in lines, lines
