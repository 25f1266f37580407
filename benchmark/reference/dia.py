"""Plain float32 PyTorch Dia-1.6B (nari-labs/Dia-1.6B's architecture),
teacher-forced over a served request.

From the published model (dia/layers.py): byte tokens ([S1]/[S2] as 0x01 /
0x02); an encoder of pre-norm RMS-norm layers with NEOX rotary (theta 1e4)
self-attention without the 1/sqrt(d) scale, a SiLU-gated FFN, over the
full 1024-byte context, positions past the prompt attending only each
other; a decoder whose rows sum the 9 codebooks' embeddings, with causal
GQA self-attention (16 query, 4 key/value heads, rotary, unscaled),
rotary cross-attention over the whole encoder context (keys past the
prompt zero, no mask, unscaled) and the gated FFN; classifier-free
guidance: the same decoder on the conditional encoding and on the
unconditional one (all-zero bytes), merged as cond + 3 (cond - uncond),
ids past EOS excluded.  The decode inputs follow the delay pattern's EOS
drain: codebook h reads BOS until step h; the drain starts when codebook 0
emits EOS or the position nears the request's cap, then feeds each
codebook EOS at its delay and PAD after.  No cache, no kernels: one causal
forward over all steps.  Departures: none in the mathematics."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import dac
from reference.common import keep, tensor


def load(reader, cfg: dict, device) -> dict:
    def t(name):
        return tensor(reader, name, device)

    enc = {"emb": t("dia.encoder.embedding"), "norm": t("dia.encoder.norm"), "layers": []}
    for i in range(cfg["encoder_n_layer"]):
        pre = f"dia.encoder.layers.{i}"
        enc["layers"].append({n: t(f"{pre}.{n}") for n in (
            "q_proj", "k_proj", "v_proj", "o_proj", "pre_sa_norm", "post_sa_norm",
            "gate", "up", "wo")})
    C = cfg["channels"]
    dec = {"norm": t("dia.decoder.norm"),
           "embeds": [t(f"dia.decoder.embeddings.{i}") for i in range(C)],
           "heads": torch.stack([t(f"dia.decoder.heads.{i}") for i in range(C)]), "layers": []}
    for i in range(cfg["decoder_n_layer"]):
        pre = f"dia.decoder.layers.{i}"
        dec["layers"].append({n: t(f"{pre}.{n}") for n in (
            "self_q_proj", "self_k_proj", "self_v_proj", "self_o_proj", "cross_q_proj",
            "cross_k_proj", "cross_v_proj", "cross_o_proj", "pre_sa_norm", "pre_ca_norm",
            "pre_mlp_norm", "gate", "up", "wo")})
    return {"enc": enc, "dec": dec, "dac": dac.load(reader, cfg, device)}


def prompt_bytes(text: str) -> list[int]:
    text = text.strip()
    if not text.startswith(("[S1]", "[S2]")):
        text = "[S1] " + text
    if not text.endswith("."):
        text += "."
    return list(text.replace("[S1]", "\x01").replace("[S2]", "\x02").encode("utf-8"))


def _rms(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5) * w


def _rope(x, pos, theta=10000.0):
    """x [..., n, H, hs] at positions pos [n]: NEOX rotation of halves."""
    hs = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hs, 2, device=x.device, dtype=torch.float32) / hs)
    ang = pos.float()[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :hs // 2], x[..., hs // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def _attn(q, k, v, mask=None):
    """q [B, n, Hq, hs], k/v [B, m, Hkv, hs] (query head j reads key/value
    head j // (Hq / Hkv)) -> [B, n, Hq * hs]; unscaled softmax."""
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k)
    if mask is not None:
        s = s + mask
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v)
    return out.reshape(q.shape[0], q.shape[1], -1)


def encode(p: dict, cfg: dict, ids: list[int], act=keep) -> torch.Tensor:
    """The conditional and unconditional encodings [2, context, hidden]."""
    ctx, H = cfg["text_length"], cfg["encoder_n_head"]
    dev = p["enc"]["emb"].device
    tokens = torch.zeros((2, ctx), dtype=torch.long, device=dev)
    tokens[0, :len(ids)] = torch.tensor(ids, device=dev)
    x = p["enc"]["emb"][tokens]
    pos = torch.arange(ctx, device=dev)
    valid = pos < len(ids)
    mask = torch.where(valid[:, None] == valid[None, :], 0.0, -1e9)
    for L in p["enc"]["layers"]:
        h = act(_rms(x, L["pre_sa_norm"]))
        q = _rope((h @ L["q_proj"].T).reshape(2, ctx, H, -1), pos)
        k = act(_rope((h @ L["k_proj"].T).reshape(2, ctx, H, -1), pos))
        v = act((h @ L["v_proj"].T).reshape(2, ctx, H, -1))
        x = x + act(_attn(q, k, v, mask)) @ L["o_proj"].T
        h = act(_rms(x, L["post_sa_norm"]))
        x = x + act(F.silu(h @ L["gate"].T) * (h @ L["up"].T)) @ L["wo"].T
    return _rms(x, p["enc"]["norm"])


def input_rows(cfg: dict, rows: np.ndarray, limit: int) -> np.ndarray:
    """The decode inputs of the steps a request emitted (limit: its
    max_tokens): step 0 all BOS, step t + 1 from step t's output and the
    drain counter."""
    C = cfg["channels"]
    A = cfg["tgt_vocab_size"] - 4
    eos, pad, bos = A, A + 1, A + 2
    delays = np.asarray(cfg["delay_pattern"])
    max_delay = int(delays.max())
    heads = np.arange(C)
    ins = np.full((len(rows), C), bos, np.int64)
    dcur = -1
    for t in range(len(rows) - 1):
        after = t + 1
        nxt = np.where(after > heads, rows[t], bos)
        if dcur == -1 and (nxt[0] == eos or after >= limit - max_delay):
            dcur = max_delay
        if dcur > 0:
            step = max_delay - dcur
            nxt = np.where(step == delays, eos, np.where(step > delays, pad, nxt))
            dcur -= 1
        ins[t + 1] = nxt
    return ins


def logits(p: dict, cfg: dict, item: dict, rows: np.ndarray,
           act=keep) -> tuple[torch.Tensor, int]:
    """The CFG-merged logits [S, 9, vocab] of the steps a request emitted,
    and the prompt's byte count.  `act` rounds every linear's input and
    every key and value (the identity: float32; `common.fp8`: the control)."""
    ids = prompt_bytes(item["text"])
    enc = encode(p, cfg, ids, act)
    Hq, Hkv, hs = (cfg["decoder_gqa_query_heads"], cfg["decoder_kv_heads"],
                   cfg["decoder_gqa_head_dim"])
    ctx = cfg["text_length"]
    dev = enc.device
    S = len(rows)
    ins = torch.from_numpy(input_rows(cfg, rows, item["max_tokens"])).to(dev)
    emb = p["dec"]["embeds"]
    x = sum(emb[h][ins[:, h] % emb[h].shape[0]] for h in range(len(emb)))
    x = x[None].expand(2, S, -1)
    pos, cpos = torch.arange(S, device=dev), torch.arange(ctx, device=dev)
    mask = torch.full((S, S), -1e9, device=dev).triu(1)
    valid = (cpos < len(ids)).float()[:, None, None]
    for L in p["dec"]["layers"]:
        h = act(_rms(x, L["pre_sa_norm"]))
        q = _rope((h @ L["self_q_proj"].T).reshape(2, S, Hq, hs), pos)
        k = act(_rope((h @ L["self_k_proj"].T).reshape(2, S, Hkv, hs), pos))
        v = act((h @ L["self_v_proj"].T).reshape(2, S, Hkv, hs))
        x = x + act(_attn(q, k, v, mask)) @ L["self_o_proj"].T
        h = act(_rms(x, L["pre_ca_norm"]))
        e = act(enc)
        ck = act(_rope((e @ L["cross_k_proj"].T).reshape(2, ctx, Hq, hs), cpos) * valid)
        cv = act((e @ L["cross_v_proj"].T).reshape(2, ctx, Hq, hs))
        q = _rope((h @ L["cross_q_proj"].T).reshape(2, S, Hq, hs), pos)
        x = x + act(_attn(q, ck, cv)) @ L["cross_o_proj"].T
        h = act(_rms(x, L["pre_mlp_norm"]))
        x = x + act(F.silu(h @ L["gate"].T) * (h @ L["up"].T)) @ L["wo"].T
    x = act(_rms(x, p["dec"]["norm"]))
    lg = torch.einsum("bsd,cvd->bscv", x, p["dec"]["heads"])
    merged = lg[0] + cfg["cfg_scale"] * (lg[0] - lg[1])
    merged[..., cfg["tgt_vocab_size"] - 4 + 1:] = float("-inf")
    return merged, len(ids)


def frames(cfg: dict, rows: np.ndarray) -> np.ndarray:
    """The delay un-weave: frame i, codebook h is step i + delay[h]'s token
    of h; a frame holding any id past the audio codes is dropped."""
    delays = np.asarray(cfg["delay_pattern"])
    A, C = cfg["tgt_vocab_size"] - 4, cfg["channels"]
    n = len(rows) - int(delays.max())
    if n <= 0:
        return np.zeros((0, C), np.int64)
    f = np.stack([rows[delays[h]:delays[h] + n, h] for h in range(C)], axis=1)
    return f[(f < A).all(axis=1)]


def audio(p: dict, cfg: dict, item: dict, rows: np.ndarray) -> torch.Tensor:
    """The request's audio: the DAC's decode of the served rows' frames."""
    return dac.decode(p["dac"], frames(cfg, rows))
