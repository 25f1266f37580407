"""One decode step over static device buffers, run eagerly or captured on the
card as one CUDA graph and replayed: the counterpart of a decode step the
JAX package compiles (Orpheus's jitted `orpheus_decode_step`, the bodies of
Parler's and Dia's `lax.while_loop`s).

A model's step subclasses `CapturedStep` and writes `_step`, which reads
and writes only tensors the step owns (its buffers, the params, the
caches), so that a replay, which calls no Python, does what a call would.
With `capture` (a card only) the first `run` is that request's step run
eagerly on a side stream (it meets whatever a first call initializes: the
kernel library, the workspace of a cuBLAS call, the sampler's constants),
then the step is captured into one CUDA graph, under the caller's
serialization of the runner (the server's runner lock); every later `run`
replays it.  `generator` is registered with the graph, so a replay draws
from its state at that moment and advances it by what the captured draw
consumed, as an eager step would: a runner reseeds it per request.  A
replay adds what the capture launched to each kernel wrapper's
`.launches`, so the counts stay what the card ran; the capture itself
launches nothing.  A failed capture raises TTSError.  Without `capture`
`run` calls the step: eager launches on the card, plain calls on the CPU.

`read_behind` is the sequential loops' host side: it runs a step, copies
the step's static output slot to pinned host memory behind an event, and
hands each copy over once `lookahead` later steps are enqueued, so the
card keeps working while the host checks for the stop.  `device_pos` is a
step's position as the device tensor its body reads.
"""

from __future__ import annotations

import collections

import torch

from tts_tpu_torch.ops.attention import flash_decode, prefix_attention
from tts_tpu_torch.ops.qmatmul import qgemm_int4, qgemm_int8, qgemv_int4, qgemv_int8
from tts_tpu_torch.ops.sampling import sample_tokens
from tts_tpu_torch.runtime.api import TTSError
from tts_tpu_torch.utils import trace

# the kernel wrappers whose `.launches` a graph replay adds to (what the
# capture launched: a replay calls no wrapper)
KERNELS = (qgemv_int8, qgemm_int8, qgemv_int4, qgemm_int4, flash_decode, prefix_attention)


class CapturedStep:
    """The capture mechanics of a sampled decode step, and its sampler:
    `key` is the static (top_k, do_sample, use_top_p) the step was made
    for, `values` the 0-d f32 temperature, top_p and repetition penalty the
    sampler reads as tensors (a Python float would be baked into a
    capture), so a later request's values are the ones a replay uses.  A
    subclass sets `state` ({"last", "count"}: views of its output slot
    `buf`) and writes `_step`; `label` names the model in errors."""

    label = "decode"

    def __init__(self, device, generator: torch.Generator | None, *, top_k: int = 0,
                 do_sample: bool = True, use_top_p: bool = True, capture: bool = False):
        device = torch.device(device)
        if capture and device.type != "cuda":
            raise ValueError(f"{type(self).__name__}: a CUDA graph is captured on a card, "
                             f"not on {device}")
        self.device, self.generator, self.capture = device, generator, capture
        self.top_k, self.do_sample, self.use_top_p = top_k, do_sample, use_top_p
        self.graph: torch.cuda.CUDAGraph | None = None
        self._launches: list = []
        with torch.inference_mode():
            self.values = torch.ones(3, dtype=torch.float32, device=device)

    @property
    def route(self) -> str:
        return "graph" if self.capture else "eager"

    @property
    def key(self) -> tuple:
        return (self.top_k, self.do_sample, self.use_top_p)

    def _load_sampler(self, state: dict, temperature: float, top_p: float,
                      repetition_penalty: float):
        """Fill the sampler state and values for the next step: device
        copies and fills, no host synchronization."""
        with torch.inference_mode():
            for k in ("last", "count"):
                self.state[k].copy_(state[k].reshape(self.state[k].shape))
            for i, v in enumerate((temperature, top_p, repetition_penalty)):
                self.values[i].fill_(float(v))

    def _sample(self, logits: torch.Tensor):
        """`sample_tokens` on logits [H, V] with the step's key, values,
        state and generator."""
        return sample_tokens(self.generator, logits, self.state, temperature=self.values[0],
                             top_k=self.top_k, top_p=self.values[1],
                             repetition_penalty=self.values[2], do_sample=self.do_sample,
                             use_top_p=self.use_top_p)

    def _step(self):
        raise NotImplementedError

    def _capture(self):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step()
        main.wait_stream(side)
        before = [k.launches for k in KERNELS]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
        except Exception as e:
            raise TTSError(f"{self.label}: capturing the decode step {self.key} failed: "
                           f"{type(e).__name__}: {e}") from e
        finally:
            captured = [k.launches - b for k, b in zip(KERNELS, before)]
            for k, b in zip(KERNELS, before):
                k.launches = b          # the capture launched nothing on the card
        self._launches = [(k, n) for k, n in zip(KERNELS, captured) if n]
        self.graph = graph

    def run(self):
        """One decode step: a replay, or the first step and the capture, or
        an eager step."""
        with torch.inference_mode():
            if self.graph is not None:
                self.graph.replay()
                for k, n in self._launches:
                    k.launches += n
            elif self.capture:
                self._capture()
            else:
                self._step()


def device_pos(pos, device) -> torch.Tensor:
    """A decode step's position as the device int32 tensor [1] it reads (an
    int is made one)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1)
    return torch.tensor([pos], dtype=torch.int32, device=device)


def read_behind(step: CapturedStep, limit: int, lookahead: int):
    """Run `step` up to `limit` times; yield each run's `step.buf` as a host
    int32 row, in order, once `lookahead` later runs are enqueued (the
    last ones at once).  At most `lookahead` runs happen, and are
    discarded, after the row where the caller stops iterating.

    The loop is one `decode` span (`utils/trace.py`), ended when the
    caller stops iterating: `rows` read, `attn_launches` (the
    `prefix_attention` launches of its runs, the discarded ones included:
    one a layer and step on a card, 0 on the CPU) and, on a card,
    `device_ns` and `idle_ns` from an event before each run and the timed
    event after its copy, read after one synchronization at the end (host
    time inside `step.run` before its launch counts as device time).  With
    the recorder off it makes one untimed event a run."""
    cuda = step.device.type == "cuda"
    host = torch.empty((limit, step.buf.numel()), dtype=torch.int32, pin_memory=cuda)
    pending: collections.deque = collections.deque()   # an event per unread run
    enqueued = read = 0
    span = trace.span("decode")
    timed = cuda and span is not trace.NOOP
    attn_before = prefix_attention.launches
    starts: list = []
    ends: list = []
    try:
        while read < limit:
            if enqueued < limit:
                if timed:
                    starts.append(torch.cuda.Event(enable_timing=True))
                    starts[-1].record()
                step.run()
                host[enqueued].copy_(step.buf, non_blocking=cuda)
                event = torch.cuda.Event(enable_timing=timed) if cuda else None
                if event is not None:
                    event.record()
                if timed:
                    ends.append(event)
                pending.append(event)
                enqueued += 1
                if len(pending) <= lookahead and enqueued < limit:
                    continue
            event = pending.popleft()
            if event is not None:
                event.synchronize()
            read += 1
            yield host[read - 1]
    finally:
        span.set("rows", read)
        span.set("attn_launches", prefix_attention.launches - attn_before)
        if timed and read:
            ends[read - 1].synchronize()
            span.set("device_ns", starts[0].elapsed_time(ends[read - 1]) * 1e6)
            span.set("idle_ns", sum(ends[i - 1].elapsed_time(starts[i])
                                    for i in range(1, read)) * 1e6)
        span.end()
