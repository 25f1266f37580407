"""Kokoro GGUF builder: emits the exact tensor/KV layout the loader consumes.

The port's own copy of `tts_tpu/convert/builder_kokoro.py` (the same draws
in the same order, so one seed gives a byte-identical file).  It writes the
random-weight Kokoro GGUFs of the port's tests (`KokoroDims.tiny()`) and of
`chip_smoke.py` (`KokoroDims.kokoro_82m()`, the full 82M-parameter widths:
real-time factor of a non-autoregressive vocoder does not depend on weight
values).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tts_tpu_torch.core.gguf import GGUFWriter


@dataclass
class KokoroDims:
    vocab: int = 178
    max_context: int = 512
    albert_embd: int = 128
    hidden: int = 768
    heads: int = 12
    ffn: int = 2048
    n_recurrence: int = 12
    dur_hidden: int = 512          # duration predictor hidden (d_hid)
    style: int = 256               # full voice style vector (2 halves)
    max_duration: int = 50
    text_hidden: int = 512         # text encoder channels
    dec_hidden: int = 1024         # decoder block channels
    gen_ch: int = 512              # generator input channels
    n_fft: int = 20
    hop: int = 5
    up_strides: tuple = (10, 6)
    up_kernels: tuple = (20, 12)
    n_kernels: int = 3
    res_kernels: tuple = (3, 7, 11)
    res_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    @staticmethod
    def tiny() -> "KokoroDims":
        return KokoroDims(vocab=40, max_context=512, albert_embd=16, hidden=32,
                          heads=4, ffn=48, n_recurrence=2, dur_hidden=32,
                          style=32, max_duration=50, text_hidden=32,
                          dec_hidden=48, gen_ch=32)

    @staticmethod
    def kokoro_82m() -> "KokoroDims":
        return KokoroDims()


def build_kokoro_tensors(dims: KokoroDims, rng: np.random.Generator,
                         voices=("af_heart",), scale: float = 0.05,
                         duration_bias: float | None = None):
    """Returns (tensors: dict[str, np.ndarray], kv: dict).

    duration_bias: constant fill for duration_proj_bias — sets the random
    model's mean per-token duration (sum of max_duration sigmoids ~
    max_duration * sigmoid(bias)).  A bias of -2.2 gives ~5 frames per
    token (~125 ms per phoneme: realistic speech), so RTF is measured at
    honest audio lengths instead of the ~25 frames per token a zero-mean
    random bias produces.
    """
    T: dict[str, np.ndarray] = {}

    def t(name, *shape):
        T[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
        return T[name]

    d = dims
    style_half = d.style // 2

    # ---- albert ----
    a = "kokoro.albert"
    t(f"{a}.token_embd", d.vocab, d.albert_embd)
    t(f"{a}.position_embd", d.max_context, d.albert_embd)
    t(f"{a}.token_type_embd", d.albert_embd)
    t(f"{a}.norm", d.albert_embd)
    t(f"{a}.norm_bias", d.albert_embd)
    t(f"{a}.embd", d.hidden, d.albert_embd)
    t(f"{a}.embd_bias", d.hidden)
    L = f"{a}.layer.0"
    for n in ("q", "k", "v", "o"):
        t(f"{L}.{n}", d.hidden, d.hidden)
        t(f"{L}.{n}_bias", d.hidden)
    for n in ("ffn_norm", "ffn_norm_bias", "attn_norm", "attn_norm_bias"):
        t(f"{L}.{n}", d.hidden)
    t(f"{L}.ffn", d.ffn, d.hidden)
    t(f"{L}.ffn_bias", d.ffn)
    t(f"{L}.ffn_out", d.hidden, d.ffn)
    t(f"{L}.ffn_out_bias", d.hidden)

    # ---- lstm helper (bidirectional cell, GGUF 8-tensor layout) ----
    def lstm(prefix, in_dim, hid):
        for rev in ("", "reverse_"):
            for g in range(4):
                t(f"{prefix}.0.{rev}weights.{2 * g}", hid, in_dim)
                t(f"{prefix}.0.{rev}weights.{2 * g + 1}", hid, hid)
                t(f"{prefix}.0.{rev}biases.{2 * g}", hid)
                t(f"{prefix}.0.{rev}biases.{2 * g + 1}", hid)

    def ada_block(base, cin, cout, pool=False):
        t(f"{base}.conv1_weight", cout, cin, 3)
        t(f"{base}.conv1_bias", cout)
        t(f"{base}.conv2_weight", cout, cout, 3)
        t(f"{base}.conv2_bias", cout)
        for n, c in (("norm1", cin), ("norm2", cout)):
            t(f"{base}.{n}_gamma_weight", c, style_half)
            t(f"{base}.{n}_gamma_bias", c)
            t(f"{base}.{n}_beta_weight", c, style_half)
            t(f"{base}.{n}_beta_bias", c)
        if pool:
            t(f"{base}.pool_weight", cin, 1, 3)
            t(f"{base}.pool_bias", cin)
        if pool or cin != cout:
            t(f"{base}.conv1x1_weight", cout, cin, 1)
            t(f"{base}.conv1x1_bias", cout)

    # ---- duration predictor ----
    dp = "kokoro.duration_predictor"
    t(f"{dp}.encode", d.dur_hidden, d.hidden)
    t(f"{dp}.encode_bias", d.dur_hidden)
    dsty = d.dur_hidden + style_half
    for i in range(3):
        lstm(f"{dp}.layers.{2 * i}.lstm", dsty, d.dur_hidden // 2)
        t(f"{dp}.layers.{2 * i + 1}.gamma_weight", d.dur_hidden, style_half)
        t(f"{dp}.layers.{2 * i + 1}.gamma_bias", d.dur_hidden)
        t(f"{dp}.layers.{2 * i + 1}.beta_weight", d.dur_hidden, style_half)
        t(f"{dp}.layers.{2 * i + 1}.beta_bias", d.dur_hidden)
    lstm(f"{dp}.duration_lstm", dsty, d.dur_hidden // 2)
    t(f"{dp}.duration_proj", d.max_duration, d.dur_hidden)
    if duration_bias is not None:
        T[f"{dp}.duration_proj_bias"] = np.full(d.max_duration, duration_bias,
                                                np.float32)
    else:
        t(f"{dp}.duration_proj_bias", d.max_duration)
    lstm(f"{dp}.shared_lstm", dsty, d.dur_hidden // 2)
    # F0/N: (d, d), (d, d/2, pool), (d/2, d/2)  [StyleTTS2 ProsodyPredictor]
    for br in ("f0", "n"):
        ada_block(f"{dp}.{br}_blocks.0", d.dur_hidden, d.dur_hidden)
        ada_block(f"{dp}.{br}_blocks.1", d.dur_hidden, d.dur_hidden // 2, pool=True)
        ada_block(f"{dp}.{br}_blocks.2", d.dur_hidden // 2, d.dur_hidden // 2)
    t(f"{dp}.f0_proj_kernel", 1, d.dur_hidden // 2, 1)
    t(f"{dp}.f0_proj_bias", 1)
    t(f"{dp}.n_proj_kernel", 1, d.dur_hidden // 2, 1)
    t(f"{dp}.n_proj_bias", 1)

    # ---- text encoder ----
    te = "kokoro.text_encoder"
    t(f"{te}.embedding_weight", d.vocab, d.text_hidden)
    for i in range(3):
        t(f"{te}.layers.{i}.weight", d.text_hidden, d.text_hidden, 5)
        t(f"{te}.layers.{i}.bias", d.text_hidden)
        t(f"{te}.layers.{i}.gamma", d.text_hidden)
        t(f"{te}.layers.{i}.beta", d.text_hidden)
    lstm(f"{te}.lstm", d.text_hidden, d.text_hidden // 2)

    # ---- decoder ----
    dec = "kokoro.decoder"
    t(f"{dec}.f0_conv_weight", 1, 1, 3)
    t(f"{dec}.f0_conv_bias", 1)
    t(f"{dec}.n_conv_weight", 1, 1, 3)
    t(f"{dec}.n_conv_bias", 1)
    t(f"{dec}.asr_conv_weight", 64 if d.text_hidden >= 64 else d.text_hidden,
      d.text_hidden, 1)
    asr_res_ch = T[f"{dec}.asr_conv_weight"].shape[0]
    t(f"{dec}.asr_conv_bias", asr_res_ch)
    enc_in = d.text_hidden + 2
    ada_block(f"{dec}.encoder_block", enc_in, d.dec_hidden)
    blk_in = d.dec_hidden + asr_res_ch + 2
    ada_block(f"{dec}.decoder_blocks.0", blk_in, d.dec_hidden)
    ada_block(f"{dec}.decoder_blocks.1", blk_in, d.dec_hidden)
    ada_block(f"{dec}.decoder_blocks.2", blk_in, d.dec_hidden)
    ada_block(f"{dec}.decoder_blocks.3", blk_in, d.gen_ch, pool=True)

    # ---- generator ----
    g = f"{dec}.generator"
    nh = 9
    t(f"{g}.m_source_weight", 1, nh)
    t(f"{g}.m_source_bias", 1)
    n_bins = d.n_fft // 2 + 1
    ch = [d.gen_ch // (2 ** (i + 1)) for i in range(len(d.up_strides))]
    prev = d.gen_ch
    for i, (s, k) in enumerate(zip(d.up_strides, d.up_kernels)):
        t(f"{g}.ups.{i}.weight", prev, ch[i], k)        # ConvTranspose1d layout
        t(f"{g}.ups.{i}.bias", ch[i])
        prev = ch[i]

    def gen_res(base, c, kernels=d.res_kernels):
        for j in range(3):
            kj = kernels[j % len(kernels)] if isinstance(kernels, tuple) else kernels
            t(f"{base}.{j}.convs1_weight", c, c, kj)
            t(f"{base}.{j}.convs1_bias", c)
            t(f"{base}.{j}.convs2_weight", c, c, kj)
            t(f"{base}.{j}.convs2_bias", c)
            T[f"{base}.{j}.alpha1"] = np.ones((1, c, 1), np.float32)
            T[f"{base}.{j}.alpha2"] = np.ones((1, c, 1), np.float32)
            t(f"{base}.{j}.gamma1_weight", c, style_half)
            t(f"{base}.{j}.gamma1_bias", c)
            t(f"{base}.{j}.beta1_weight", c, style_half)
            t(f"{base}.{j}.beta1_bias", c)
            t(f"{base}.{j}.gamma2_weight", c, style_half)
            t(f"{base}.{j}.gamma2_bias", c)
            t(f"{base}.{j}.beta2_weight", c, style_half)
            t(f"{base}.{j}.beta2_bias", c)

    noise_strides = (d.up_strides[1] * 1, 1)
    noise_kernels = (d.up_strides[1] * 2, 1)
    noise_paddings = (d.up_strides[1] // 2, 0)
    for i in range(len(d.up_strides)):
        t(f"{g}.noise_blocks.{i}.conv_weight", ch[i], 2 * n_bins, noise_kernels[i])
        t(f"{g}.noise_blocks.{i}.conv_bias", ch[i])
        gen_res(f"{g}.noise_blocks.{i}.resblock", ch[i], kernels=7)
    for i in range(len(d.up_strides) * d.n_kernels):
        gen_res(f"{g}.resblocks.{i}", ch[i // d.n_kernels],
                kernels=d.res_kernels[i % d.n_kernels])
    t(f"{g}.conv_post_weight", 2 * n_bins, ch[-1], 7)
    t(f"{g}.conv_post_bias", 2 * n_bins)

    # ---- voices ----
    for v in voices:
        T[f"kokoro.voice_tensors.{v}"] = (
            rng.standard_normal((510, d.style)) * scale).astype(np.float32)

    # ---- KV metadata ----
    kv = {
        "general.architecture": "kokoro",
        "kokoro.duration_predictor.albert.context_length": d.max_context,
        "kokoro.tokenizer.vocab_size": d.vocab,
        "kokoro.duration_predictor.albert.hidden_size": d.hidden,
        "kokoro.duration_predictor.albert.attn_heads": d.heads,
        "kokoro.duration_predictor.albert.layers": 1,
        "kokoro.duration_predictor.albert.recurrence": d.n_recurrence,
        "kokoro.duration_predictor.hidden_size": d.dur_hidden,
        "kokoro.duration_predictor.layers": 3,
        "kokoro.duration_predictor.f0_n_blocks": 3,
        "kokoro.text_encoder.layers": 3,
        "kokoro.decoder.generator.up_sampling_factor": 600,
        "kokoro.decoder.generator.kernels": d.n_kernels,
        "kokoro.decoder.generator.upsamples": len(d.up_strides),
        "kokoro.decoder.generator.layers": 4,
        "kokoro.decoder.generator.padding": 3,
    }
    kv["kokoro.decoder.generator.n_fft"] = d.n_fft
    kv["kokoro.decoder.generator.hop"] = d.hop
    for i, (s, k) in enumerate(zip(d.up_strides, d.up_kernels)):
        kv[f"kokoro.decoder.generator.up_convs.{i}.stride"] = s
        kv[f"kokoro.decoder.generator.up_convs.{i}.padding"] = (k - s) // 2
    for i in range(len(d.up_strides)):
        kv[f"kokoro.decoder.generator.noise_blocks.{i}.stride"] = noise_strides[i]
        kv[f"kokoro.decoder.generator.noise_blocks.{i}.padding"] = noise_paddings[i]
        for j in range(3):
            kv[f"kokoro.decoder.generator.noise_blocks.{i}.res_block.{j}.padding"] = 3
            kv[f"kokoro.decoder.generator.noise_blocks.{i}.res_block.{j}.dilation"] = 1
    for i in range(len(d.up_strides) * d.n_kernels):
        kj = d.res_kernels[i % d.n_kernels]
        dil = d.res_dilations[i % d.n_kernels]
        for j in range(3):
            kv[f"kokoro.decoder.generator.res_blocks.{i}.{j}.padding"] = (
                (kj - 1) * dil[j] // 2)
            kv[f"kokoro.decoder.generator.res_blocks.{i}.{j}.dilation"] = dil[j]
    kv["kokoro.voices"] = list(voices)
    if duration_bias is not None:
        # the expected speaking rate of this duration head (sigmoid(bias) *
        # max_duration): the JAX package's frame-bucket predictor reads it;
        # the port runs exact shapes and does not
        kv["kokoro.frames_per_token"] = float(
            d.max_duration / (1.0 + np.exp(-duration_bias)))

    # tokenizer: ids 0..vocab-1; id 0 = "" (bos/eos), id 16 = " " when possible
    tokens = [""] + [chr(ord("a") + i) if i < 26 else f"<{i}>"
                     for i in range(d.vocab - 1)]
    if d.vocab > 16:
        tokens[16] = " "
    kv["tokenizer.ggml.tokens"] = tokens
    kv["tokenizer.ggml.eos_token_id"] = 0

    # minimal built-in phonemizer tables (type 0 = TTS rules)
    kv["phonemizer.type"] = 0
    kv["phonemizer.phoneme_type"] = 1
    kv["phonemizer.graphemes"] = [chr(ord("a") + i) for i in range(26)]
    kv["phonemizer.rules.keys"] = [chr(ord("a") + i) for i in range(26)]
    kv["phonemizer.rules.phonemes"] = [chr(ord("a") + i) for i in range(26)]
    kv["phonemizer.dictionary.keys"] = ["hello", "world"]
    kv["phonemizer.dictionary.values"] = ["hɛlo", "wɝld"]
    return T, kv


def write_kokoro_gguf(path, dims: KokoroDims, seed: int = 0, voices=("af_heart",),
                      duration_bias: float | None = None):
    rng = np.random.default_rng(seed)
    tensors, kv = build_kokoro_tensors(dims, rng, voices=voices,
                                       duration_bias=duration_bias)
    w = GGUFWriter(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.write()
    return path
