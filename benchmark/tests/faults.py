"""Faults planted under a run's timed path (the server's process reads
BENCH_TEST_FAULT, before the benchmark's own hooks go in), for the test
that sees `correct` come out false once for each fault a cell can have.

- token: one served token altered where the decode loop produces it;
- state: every decode step leaves its position unchanged (the cache slot,
  the positional row and the rotary angle stay those of the first step);
- audio: the audio negated where the DAC produces it."""

from __future__ import annotations


def plant(name: str):
    from tts_tpu_torch.codecs.dac import DACDecoder
    from tts_tpu_torch.models import dia, parler
    from tts_tpu_torch.runtime.step_graph import CapturedStep

    if name == "token":
        for mod, fn in ((parler, "parler_decode_loop"), (dia, "dia_decode_loop")):
            loop = getattr(mod, fn)

            def altered(*args, _loop=loop, **kw):
                rows, state, loop_state = _loop(*args, **kw)
                rows = rows.copy()
                if len(rows):
                    rows[len(rows) // 2, 0] = (rows[len(rows) // 2, 0] + 1) % 1024
                return rows, state, loop_state

            setattr(mod, fn, altered)
    elif name == "state":
        for cls in CapturedStep.__subclasses__():
            step = cls._step

            def frozen(self, _step=step):
                pos = self.pos.clone()
                _step(self)
                self.pos.copy_(pos)

            cls._step = frozen
    elif name == "audio":
        decode = DACDecoder.decode
        DACDecoder.decode = lambda self, codes: -decode(self, codes)
    else:
        raise ValueError(f"no fault {name!r}")
