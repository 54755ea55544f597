"""rpc_view — proxy a remote server's builtin portal through a local port
(≙ reference tools/rpc_view: view builtin pages of a server that is only
reachable from this host).

    python -m brpc_tpu_torch.tools.rpc_view --target 10.0.0.7:8000 --port 8888
    # then browse http://localhost:8888/status etc.

``--dump DIR`` instead renders a flight-recorder capture set (rpc_dump /
native dump segments) human-readably — one line per sample: timestamp,
method, payload/attachment sizes, codec/compress tags, trace id, stream
frame kind — the quick "what is in this capture?" look before replaying.
"""

from __future__ import annotations

import argparse
import urllib.error
import urllib.request
from typing import List, Optional


def make_proxy(target: str):
    """A Server whose every HTTP path forwards to `target`'s portal."""
    from brpc_tpu_torch.rpc.http import HttpRequest, HttpResponse
    from brpc_tpu_torch.rpc.server import Server, ServerOptions
    srv = Server(ServerOptions(enable_builtin_services=False))

    def forward(req: HttpRequest) -> HttpResponse:
        url = f"http://{target}{req.path}"
        if req.query:
            url += "?" + req.query
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return HttpResponse(
                    r.status,
                    {"Content-Type": r.headers.get(
                        "Content-Type", "text/plain")},
                    r.read())
        except urllib.error.HTTPError as e:
            return HttpResponse(e.code, {}, e.read())
        except OSError as e:
            return HttpResponse.text(f"cannot reach {target}: {e}\n", 502)

    srv.register_http("/", forward, prefix=True)
    return srv


_FRAME_KINDS = {0: "unary", 1: "data", 2: "close", 3: "feedback"}


def format_sample(s) -> str:
    """One human line per captured sample (method, sizes, codec/compress
    tags, trace id, timestamp, stream frame kind)."""
    import datetime
    ts = datetime.datetime.fromtimestamp(s.timestamp).strftime(
        "%Y-%m-%d %H:%M:%S.%f") if s.timestamp else "-"
    kind = _FRAME_KINDS.get(s.stream_frame_type,
                            str(s.stream_frame_type))
    if s.stream_id and s.stream_frame_type == 0:
        kind = "stream-open"
    parts = [ts, f"{s.method or '-':<24}", kind,
             f"payload={len(s.payload)}B"]
    if s.attachment:
        parts.append(f"attach={len(s.attachment)}B")
    if s.compress_type:
        parts.append(f"compress={s.compress_type}")
    if s.payload_codec or s.attach_codec:
        parts.append(f"codec={s.payload_codec}/{s.attach_codec}")
    if s.trace_id:
        parts.append(f"trace={s.trace_id:016x}")
    if s.stream_id:
        parts.append(f"stream={s.stream_id}")
    return "  ".join(parts)


def view_dump(dump_dir: str) -> int:
    """Render every sample in a capture set, one line each, plus a
    trailing per-method tally.  Returns the sample count."""
    from collections import Counter

    from brpc_tpu_torch.rpc.dump import SampleIterator
    n = 0
    by_method: Counter = Counter()
    for s in SampleIterator(dump_dir):
        print(format_sample(s))
        by_method[s.method or "-"] += 1
        n += 1
    if n:
        tally = ", ".join(f"{m}={c}" for m, c in by_method.most_common())
        print(f"-- {n} samples: {tally}")
    else:
        print(f"-- no samples under {dump_dir}")
    return n


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="portal proxy / dump viewer")
    ap.add_argument("--target", help="remote ip:port to proxy")
    ap.add_argument("--port", type=int, default=8888)
    ap.add_argument("--dump", metavar="DIR",
                    help="render a flight-recorder capture set instead "
                         "of proxying (one line per sample)")
    args = ap.parse_args(argv)
    if args.dump:
        view_dump(args.dump)
        return 0
    if not args.target:
        ap.error("--target is required unless --dump is given")
    srv = make_proxy(args.target)
    srv.start(f"0.0.0.0:{args.port}")
    print(f"viewing {args.target} on http://localhost:{srv.port}/")
    try:
        import time
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.destroy()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
