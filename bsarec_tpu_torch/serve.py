"""Minimal HTTP serving host for exported scorer artifacts (counterpart of
`bsarec_tpu/serve.py`).

    python -m bsarec_tpu_torch.serve scorer.pt2 --port 8123 [--device cpu]

Loads a `--export_serving` artifact (`serving.py`) on the card (or the
CPU when asked) and serves ranked recommendations over plain HTTP with
the standard library's server.

API:

- `GET /healthz` -> `{"ok": true, "max_len": L, "seen_width": S}`
- `POST /rank` with JSON `{"input_ids": [[...], ...]}` (ragged histories
  fine; optional `"user_ids"`, `"seen_items"`) -> `{"topk": [[20 ids]]}`.
  Histories are left-padded/truncated to the artifact's max_len (the
  training pipeline's layout, `data/pipeline.py`). By default a user's
  history items are masked to -inf and never appear in their results;
  pass `"mask_history": false` to rank over the full catalog. The seen
  mask holds at most the artifact's `seen_width` ids (the MOST-RECENT
  ones); when that cap truncates any request the response carries
  `"seen_truncated": [row indices]`.
- A malformed body gets a 400 JSON `{"error": ...}`, and so does an
  `input_ids` entry outside [0, item_size): the JAX host ranks such a row
  (its embedding lookup fills NaN), the port refuses it, since on the
  card the lookup would fire a device assert.

The artifact is batch-polymorphic; the host warms batch 1 at startup.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from bsarec_tpu_torch.config import set_fp32_matmul
from bsarec_tpu_torch.serving import Scorer, load_scorer


def pad_requests(histories, max_len: int, seen_width: int,
                 mask_history: bool = True, seen_items=None):
    """Ragged per-user histories -> the artifact's fixed-shape inputs.

    Left-pads (pad id 0) or left-truncates each history to `max_len`
    (most-recent items kept, matching `data/pipeline.py`'s layout), and
    builds `seen_items` from the history unless given explicitly — up to
    the artifact's fixed `seen_width` capacity: histories longer than
    that keep their MOST-RECENT `seen_width` ids and lose masking of the
    oldest. Returns (input_ids, seen, truncated_rows) where
    `truncated_rows` lists the indices whose seen mask was capped.
    """
    b = len(histories)
    input_ids = np.zeros((b, max_len), np.int32)
    seen = np.zeros((b, seen_width), np.int32)
    truncated = []
    for i, h in enumerate(histories):
        h = list(h)
        if h:
            tail = h[-max_len:]
            input_ids[i, max_len - len(tail):] = tail
        if seen_items is not None:
            s = list(seen_items[i])[:seen_width]
            seen[i, :len(s)] = s
            if len(seen_items[i]) > seen_width:
                truncated.append(i)
        elif mask_history:
            s = h[-seen_width:]
            seen[i, :len(s)] = s
            if len(h) > seen_width:
                truncated.append(i)
    return input_ids, seen, truncated


def rank_request(scorer: Scorer, payload: dict) -> dict:
    """One /rank body -> response dict."""
    histories = payload["input_ids"]
    if not histories:
        return {"topk": []}
    input_ids, seen, truncated = pad_requests(
        histories, scorer.max_len, scorer.seen_width,
        mask_history=payload.get("mask_history", True),
        seen_items=payload.get("seen_items"),
    )
    user_ids = payload.get("user_ids")
    if user_ids is not None:
        user_ids = np.asarray(user_ids, np.int32)
    topk = scorer.topk(input_ids, user_ids, seen)
    out = {"topk": topk.tolist()}
    if truncated:  # seen mask capped at seen_width for these rows
        out["seen_truncated"] = truncated
    return out


def make_server(scorer: Scorer, host: str = "127.0.0.1", port: int = 0):
    """A ThreadingHTTPServer bound to (host, port); call serve_forever()."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: dict):
            blob = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "max_len": scorer.max_len,
                                  "seen_width": scorer.seen_width})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/rank":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, rank_request(scorer, payload))
            except Exception as e:  # noqa: BLE001 — any malformed body
                # (bad JSON, ragged seen_items, mismatched user_ids, an id
                # out of range, ...) must produce a 400 JSON, not a
                # dropped connection
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet; the CLI logs startup
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("artifact", help="path written by --export_serving")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", default=8123, type=int)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; asking for cuda without a card raises")
    args = ap.parse_args(argv)

    set_fp32_matmul()  # fp32 logits in full fp32; int8 sums stay exact
    scorer = load_scorer(args.artifact, args.device)
    scorer.topk(np.zeros((1, scorer.max_len), np.int32))  # warm batch 1
    server = make_server(scorer, args.host, args.port)
    print(f"serving {args.artifact} on http://{args.host}:{server.server_address[1]} "
          f"({scorer.device}, max_len={scorer.max_len}, seen_width={scorer.seen_width})",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
