"""parallel_http — mass concurrent HTTP fetcher
(≙ reference tools/parallel_http: fetch many URLs with bounded
concurrency and report per-URL outcomes).  Drives the FRAMEWORK'S OWN
HTTP client (rpc/http_client.py — native data path, pooled per host),
not urllib.

    python -m brpc_tpu_torch.tools.parallel_http --url-file urls.txt -c 32
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from brpc_tpu_torch.rpc.http_client import HttpChannel


@dataclass
class FetchResult:
    url: str
    status: int          # HTTP status, or -1 on transport error
    bytes: int
    latency_ms: float
    error: str = ""


class _ChannelCache:
    """One HttpChannel per (scheme, host, port) — fetches to one host
    share its connection pool."""

    def __init__(self, tls_verify: bool = True):
        self._lock = threading.Lock()
        self._chans: Dict[Tuple[str, str, int], HttpChannel] = {}
        self._tls_verify = tls_verify

    def get(self, scheme: str, host: str, port: int) -> HttpChannel:
        key = (scheme, host, port)
        with self._lock:
            ch = self._chans.get(key)
            if ch is None:
                ch = HttpChannel(f"{host}:{port}", host=host,
                                 tls=(scheme == "https"),
                                 tls_verify=self._tls_verify)
                self._chans[key] = ch
            return ch

    def close(self):
        with self._lock:
            for ch in self._chans.values():
                ch.close()
            self._chans.clear()


def fetch_all(urls: List[str], concurrency: int = 16,
              timeout_s: float = 10.0,
              tls_verify: bool = True) -> List[FetchResult]:
    cache = _ChannelCache(tls_verify=tls_verify)

    def one(url: str) -> FetchResult:
        t0 = time.monotonic()
        try:
            u = urlsplit(url if "//" in url else "http://" + url)
            port = u.port or (443 if u.scheme == "https" else 80)
            ch = cache.get(u.scheme or "http", u.hostname or "127.0.0.1",
                           port)
            target = (u.path or "/") + (f"?{u.query}" if u.query else "")
            r = ch.get(target, timeout_ms=timeout_s * 1000)
            return FetchResult(url, r.status, len(r.body),
                               (time.monotonic() - t0) * 1000)
        except Exception as e:
            return FetchResult(url, -1, 0,
                               (time.monotonic() - t0) * 1000, str(e))

    try:
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            return list(pool.map(one, urls))
    finally:
        cache.close()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="mass HTTP fetch")
    ap.add_argument("urls", nargs="*", help="URLs to fetch")
    ap.add_argument("--url-file", help="file with one URL per line")
    ap.add_argument("-c", "--concurrency", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--insecure", action="store_true",
                    help="skip TLS certificate verification")
    args = ap.parse_args(argv)
    urls = list(args.urls)
    if args.url_file:
        with open(args.url_file) as f:
            urls += [ln.strip() for ln in f if ln.strip()]
    if not urls:
        ap.error("no URLs given")
    results = fetch_all(urls, args.concurrency, args.timeout,
                        tls_verify=not args.insecure)
    ok = 0
    for r in results:
        mark = "OK " if 200 <= r.status < 300 else "ERR"
        ok += mark == "OK "
        print(f"{mark} {r.status:4d} {r.bytes:8d}B {r.latency_ms:7.1f}ms "
              f"{r.url} {r.error}", file=sys.stdout)
    print(f"{ok}/{len(results)} succeeded")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
