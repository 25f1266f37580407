"""Random weights from the run's seed, made on the device in a few large
draws and written as a GGUF file in the format the program loads.

A plan lists the tensors in file order: (name, row-major shape, kind, arg):
  "q4"   Q4_0 blocks (a linear [out, in], blocks along `in`): uniform raw
         nibbles and per block an f16 scale that gives weights of about
         `arg` (the std), +-50%, as the port's random writers draw them;
  "f16"  normal values times `arg` stored as F16; `arg` may be
         (std, first_row, factor): rows from first_row on are drawn
         `factor` times smaller (the heads' ids past the audio codes);
  "f32"  normal values times `arg`;  "ones", "zeros"  f32 constants.
The draws: one of every Q4_0 nibble byte, one of every block scale, one
of every normal value, all from one torch.Generator seeded with the seed.
The file is cached per configuration: `ensure` keeps one file for it in
`cache_dir` and writes a new one only when the seed changes."""

from __future__ import annotations

import glob
import math
import os

import numpy as np

from benchlib import gguf

# std of a uniform Q4_0 nibble minus 8: sqrt((16^2 - 1) / 12)
_Q4_RAW_STD = math.sqrt((16 * 16 - 1) / 12)


def make(path: str, kv: dict, plan: list, seed: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    q4 = [p for p in plan if p[2] == "q4"]
    nb = [int(np.prod(p[1])) // 32 for p in q4]
    n_norm = sum(int(np.prod(p[1])) for p in plan if p[2] in ("f16", "f32"))
    with torch.no_grad():
        nibbles = torch.randint(0, 256, (sum(nb), 16), generator=g, device=device,
                                dtype=torch.uint8)
        u = torch.rand(sum(nb), generator=g, device=device)
        normal = torch.randn(n_norm, generator=g, device=device)
        std = torch.cat([torch.full((n,), p[3] / _Q4_RAW_STD, device=device)
                         for p, n in zip(q4, nb)]) if q4 else u
        d = (std * (0.5 + u)).half().view(torch.uint8).reshape(-1, 2)
        blocks = torch.cat([d, nibbles], dim=1).cpu().numpy()
        del nibbles, u, std, d
        dense = {}
        at = 0
        for name, shape, kind, arg in plan:
            if kind not in ("f16", "f32"):
                continue
            n = int(np.prod(shape))
            x = normal[at:at + n].reshape(shape)
            at += n
            if isinstance(arg, (tuple, list)):
                s, first, factor = arg
                x = x * s
                x[first:] *= factor
            else:
                x = x * arg
            dense[name] = x.half() if kind == "f16" else x
        f16 = torch.cat([v.reshape(-1) for v in dense.values() if v.dtype == torch.float16]
                        or [torch.zeros(0, dtype=torch.float16, device=device)]).cpu().numpy()
        f32 = torch.cat([v.reshape(-1) for v in dense.values() if v.dtype == torch.float32]
                        or [torch.zeros(0, device=device)]).cpu().numpy()
        del normal, dense
    tensors, bo, o16, o32 = [], 0, 0, 0
    for name, shape, kind, arg in plan:
        n = int(np.prod(shape))
        if kind == "q4":
            tensors.append((name, shape, gguf.Q4_0, blocks[bo:bo + n // 32]))
            bo += n // 32
        elif kind == "f16":
            tensors.append((name, shape, gguf.F16, f16[o16:o16 + n]))
            o16 += n
        elif kind == "f32":
            tensors.append((name, shape, gguf.F32, f32[o32:o32 + n]))
            o32 += n
        else:
            fill = np.ones if kind == "ones" else np.zeros
            tensors.append((name, shape, gguf.F32, fill(n, np.float32)))
    gguf.write(path, kv, tensors)


def cached(cache_dir: str, cfg: dict, seed: int) -> str:
    """Where the configuration's weights for `seed` are kept."""
    return os.path.join(cache_dir, f"{cfg['entry']['name']}.seed{int(seed)}.gguf")


def ensure(cache_dir: str, cfg: dict, seed: int, plan, device) -> str:
    """The configuration's weights for `seed` in cache_dir, made from `plan`
    ((kv, tensors)) if that seed's file is not there; the file of an earlier
    seed is removed first: one file per configuration."""
    os.makedirs(cache_dir, exist_ok=True)
    path = cached(cache_dir, cfg, seed)
    if not os.path.exists(path):
        for old in glob.glob(os.path.join(cache_dir, f"{cfg['entry']['name']}.seed*.gguf*")):
            os.remove(old)
        make(path, *plan, seed, device)
    return path


def q4_dequant(blocks, shape, device):
    """Q4_0 blocks (uint8 [n/32 * 18]) -> f32 [out, in] on `device`: value
    j of a block is (low nibble of byte j, then high nibbles) minus 8,
    times the block's f16 scale."""
    import torch

    b = torch.from_numpy(np.array(blocks).reshape(-1, 18)).to(device)
    d = b[:, :2].contiguous().view(torch.float16).float()            # [nb, 1]
    q = b[:, 2:].to(torch.int16)
    vals = torch.cat([q & 0xF, q >> 4], dim=1).float() - 8.0          # [nb, 32]
    return (vals * d).reshape(shape)
