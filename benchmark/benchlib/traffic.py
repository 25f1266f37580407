"""The one traffic generator: a mix's parameters and a seed -> the requests.

Every seed gets the same set of sizes and the same set of arrival gaps, so
that the seed changes which text is spoken, not how much work a run holds.
Their order is drawn from the seed too, unless the mix fixes it with
`order_seed`: in an open loop near the knee the order of sizes and gaps
(which requests queue behind which) moves a tail far more than two runs of
one order differ, so there the order is the mix's and the seed draws the
texts, the requests' sampling seeds and the weights.

- `audio_s` [lo, hi]: each request's audio length, log-uniform; the sizes
  are the mix's quantiles (i + 1/2) / n, shuffled.
- `loop` "closed": one client sends the next request when the last is done,
  from blocks of `block` sizes (each block shuffled anew), enough for any
  window.  "open": Poisson arrivals at `rate_per_s` over the window: the
  n = round(rate x seconds) gaps are the exponential's quantiles, shuffled
  and scaled so that all n fall inside the window.
- `response_format`: "wav" (whole) or "pcm" (streamed).

Every mix shares the rest: every GREEDY_EVERY-th request, from the second
on, asks top_k 1 (the argmax, on the same sampled-decode route), whose
tokens the reference can judge (the second request comes early in any
window); texts run CHARS_PER_AUDIO_S characters a second of audio, made
from the ten Harvard sentences of list 1."""

from __future__ import annotations

import math
import random

FRAMES_PER_S = 44100 / 512          # DAC 44.1 kHz frames (hop 512)
GREEDY_EVERY = 4
CHARS_PER_AUDIO_S = 11

# Harvard sentences (IEEE recommended practice, public domain), list 1
SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
]


def text(rng: random.Random, n_chars: int) -> str:
    """Harvard sentences in a drawn order, cut at a word boundary to at most
    n_chars (at least one word)."""
    order = list(SENTENCES)
    rng.shuffle(order)
    out = ""
    i = 0
    while len(out) < n_chars:
        out = (out + " " + order[i % len(order)]).strip()
        i += 1
    if len(out) > n_chars:
        cut = out.rfind(" ", 0, n_chars + 1)
        out = out[:cut] if cut > 0 else out[:n_chars]
    return out


def _quantile_sizes(lo: float, hi: float, n: int) -> list[float]:
    return [lo * (hi / lo) ** ((i + 0.5) / n) for i in range(n)]


def schedule(tr: dict, model, seed: int, seconds: float) -> list[dict]:
    """The run's requests in sending order.  Each: index, `due` (seconds from
    the window's start; None in a closed loop), `audio_s` (what it yields),
    `frames`, `samples` (the 16-bit samples it must return), `top_k` (1 or
    None), and `body`, the JSON sent."""
    rng = random.Random(seed)
    order = random.Random(tr["order_seed"]) if "order_seed" in tr else rng
    lo, hi = tr["audio_s"]
    if tr["loop"] == "closed":
        sizes = []
        for _ in range(tr["blocks"]):
            block = _quantile_sizes(lo, hi, tr["block"])
            order.shuffle(block)
            sizes += block
        dues = [None] * len(sizes)
    elif tr["loop"] == "open":
        rate = float(tr["rate_per_s"])
        n = max(1, round(rate * seconds))
        sizes = _quantile_sizes(lo, hi, n)
        order.shuffle(sizes)
        gaps = [-math.log(1 - (i + 0.5) / n) for i in range(n)]
        order.shuffle(gaps)
        scale = seconds * (1 - 0.5 / n) / sum(gaps)
        dues, t = [], 0.0
        for g in gaps:
            t += g * scale
            dues.append(t)
    else:
        raise ValueError(f"unknown loop {tr['loop']!r}")
    reqs = []
    for i, (a, due) in enumerate(zip(sizes, dues)):
        frames = max(1, round(a * FRAMES_PER_S))
        greedy = i % GREEDY_EVERY == 1
        body = {"input": text(rng, max(1, round(a * CHARS_PER_AUDIO_S))),
                "max_tokens": model.max_tokens(frames),
                "seed": rng.randrange(1, 2**31 - 1),
                "response_format": tr["response_format"]}
        if greedy:
            body["top_k"] = 1
        reqs.append({"i": i, "due": due, "frames": frames, "audio_s": frames / FRAMES_PER_S,
                     "samples": model.samples(frames, body["input"]),
                     "top_k": 1 if greedy else None, "body": body})
    return reqs
