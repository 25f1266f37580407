"""The load generator's HTTP client: one POST /v1/audio/speech, timed on the
host clock (time.perf_counter, which the server's process shares)."""

from __future__ import annotations

import http.client
import io
import json
import time
import wave


def send(port: int, body: dict, timeout: float) -> dict:
    """Send one request; returns the times the request was sent, its first
    audio byte arrived and its last byte arrived, the status, and the 16-bit
    samples as bytes (the WAV's frames, or the streamed PCM)."""
    out = {"t_sent": time.perf_counter(), "t_first": None, "t_done": None,
           "status": None, "pcm": b"", "error": None}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/audio/speech", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        parts = []
        while True:
            piece = resp.read1(1 << 16)
            if not piece:
                break
            if out["t_first"] is None:
                out["t_first"] = time.perf_counter()
            parts.append(piece)
        out["t_done"] = time.perf_counter()
        data = b"".join(parts)
        if resp.status != 200:
            out["error"] = data[:300].decode("utf-8", "replace")
        elif body.get("response_format") == "pcm":
            out["pcm"] = data
        else:
            with wave.open(io.BytesIO(data)) as w:
                out["pcm"] = w.readframes(w.getnframes())
    except (OSError, http.client.HTTPException, wave.Error, EOFError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        conn.close()
    return out
