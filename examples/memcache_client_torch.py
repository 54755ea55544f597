"""Memcache binary-protocol client with batched quiet-op pipelining on the
PyTorch/CUDA port (examples/memcache_client.py on brpc_tpu_torch.rpc;
≙ example/memcache).  No memcached daemon in this image, so the demo
serves the binary protocol from a tiny in-process store (the port's
tests/test_torch_memcache.py copy of MiniMemcached): the client bytes on
the wire are exactly what stock memcached speaks.  Host only: no device.

    python examples/memcache_client_torch.py

The last stdout line is one JSON object of what the store gave back."""

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

from brpc_tpu_torch.rpc.memcache import MemcacheClient       # noqa: E402
from test_torch_memcache import MiniMemcached  # noqa: E402  (spec-faithful store)


def main() -> int:
    srv = MiniMemcached()
    c = MemcacheClient("127.0.0.1", srv.port)
    out = {}

    cas = c.set("greeting", b"hello memcache", flags=1)
    print("set   -> cas", cas)
    got = c.get("greeting")
    out["get"] = got.decode()
    print("get   ->", got)
    out["incr"] = [c.incr("hits", 1, initial=41), c.incr("hits", 1)]
    print("incr  ->", out["incr"][0])
    print("incr  ->", out["incr"][1])

    # one round trip for many keys (quiet GETKQ + NOOP batching,
    # ≙ MemcacheRequest packing N operations)
    b = c.batch()
    for i in range(5):
        b.set(f"key-{i}", f"value-{i}".encode())
    b.execute()
    many = c.multi_get([f"key-{i}" for i in range(5)] + ["missing"])
    out["multi_get"] = {k.decode(): v.decode() for k, v in many.items()}
    print("multi_get ->", out["multi_get"])

    val, cas = c.gets("greeting")
    c.set("greeting", b"compare-and-swapped", cas=cas)
    got = c.get("greeting")
    out["cas"] = got.decode()
    print("cas   ->", got)

    c.close()
    srv.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
