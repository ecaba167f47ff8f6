"""Server-Sent Events wire format for the completions stream.

The port's own copy of ``repro/serve/api/sse.py``; the bytes are the same.

One event per generated token, OpenAI-completions shaped::

    data: {"id": "cmpl-3", "object": "text_completion", "choices": [...]}\n\n

terminated by the literal ``data: [DONE]\n\n``.  ``encode_event`` /
``SSEDecoder`` are the only places the framing bytes appear — the server,
the client, and the conformance tests all route through them (the tests
additionally assert the raw bytes, so the framing can't drift silently).
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Union

DONE_PAYLOAD = "[DONE]"
DONE_EVENT = b"data: [DONE]\n\n"


def encode_event(payload: Union[dict, str]) -> bytes:
    """Frame one SSE event: ``data: <payload>\\n\\n`` (JSON for dicts)."""
    if isinstance(payload, dict):
        payload = json.dumps(payload, separators=(",", ":"))
    return b"data: " + payload.encode("utf-8") + b"\n\n"


def completion_chunk(uid, token_id: Optional[int], index: int,
                     finish_reason: Optional[str] = None) -> dict:
    """One streamed completion delta (token ids — the repo has no
    tokenizer; ``text`` carries the id's decimal form for eyeballing).
    ``token_id=None`` frames a token-less terminal event (e.g. a timeout
    before the next flush)."""
    choice = {
        "index": 0,
        "token": int(token_id) if token_id is not None else None,
        "text": str(int(token_id)) if token_id is not None else "",
        "logprobs": None,
        "finish_reason": finish_reason,
    }
    return {
        "id": str(uid),
        "object": "text_completion",
        "choices": [choice],
        "token_index": index,
    }


class SSEDecoder:
    """Incremental ``data:`` frame decoder (client + test side).

    Feed arbitrary byte chunks; complete event payloads come out as
    strings (``[DONE]`` included, undecoded — callers check
    ``DONE_PAYLOAD``).
    """

    def __init__(self):
        self._buf = b""

    def feed(self, data: bytes) -> List[str]:
        self._buf += data
        out = []
        while b"\n\n" in self._buf:
            frame, self._buf = self._buf.split(b"\n\n", 1)
            for line in frame.split(b"\n"):
                if line.startswith(b"data: "):
                    out.append(line[len(b"data: "):].decode("utf-8"))
        return out


def iter_payloads(chunks: Iterator[bytes]) -> Iterator[str]:
    """Decode a byte-chunk iterator into payload strings, stopping at
    ``[DONE]`` (or EOF)."""
    dec = SSEDecoder()
    for chunk in chunks:
        if not chunk:
            return
        for payload in dec.feed(chunk):
            if payload == DONE_PAYLOAD:
                return
            yield payload
