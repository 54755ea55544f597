"""The serving load generator: a child process of the run, closed loop.

Each of the mix's clients holds one channel to the server over loopback
TCP and sends its share of the request pool one request at a time (the
first requests in client order, each once the one before it is in the
server's queue, so the batch always fills in the same order),
``LLM.Generate`` with a stream attached, stamping the send and each
token as it arrives (monotonic clock, which the parent shares).  Kept
out of the server's process so that its threads do not contend for the
interpreter lock with the decode loop.

Protocol on the pipes: one JSON line in (addr, mix, seed, vocab);
"started" out; "stop" in (or end of input): no client sends again;
"ack" out; once every client has ended (the server stops and resets
the open streams), "RESULT <json>" out with every request's record.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import traffic  # noqa: E402

READ_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 120.0
SHED_RETRY_S = 0.02


def client(addr, reqs, seed, vocab, stop, out, lock, after, sent):
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
    from brpc_tpu_torch.rpc.stream import StreamReset
    ch = Channel(addr, ChannelOptions(timeout_ms=int(READ_TIMEOUT_S * 1e3),
                                      max_retry=0))
    try:
        for req in reqs:
            if stop.is_set():
                return
            prompt = traffic.prompt_tokens(seed, req["index"],
                                           req["prompt_len"], vocab)
            body = json.dumps({"prompt": prompt, "max_new_tokens":
                               req["max_new_tokens"]}).encode()
            if after is not None:     # the first requests go in client order
                after.wait()
                after = None
            rec = dict(req, t_send=time.monotonic(), stamps=[], tokens=[],
                       sheds=0, end="")
            st = None
            while st is None and not rec["end"]:
                try:
                    _, st = ch.create_stream("LLM.Generate", body)
                except errors.RpcError as e:
                    if e.code != errors.ELIMIT or stop.is_set():
                        rec["end"] = f"error {e.code}"
                    else:
                        rec["sheds"] += 1
                        time.sleep(SHED_RETRY_S)
            sent.set()
            if st is not None:
                try:
                    while True:
                        b = st.read(timeout_s=READ_TIMEOUT_S)
                        if b is None:
                            rec["end"] = "eof"
                            break
                        rec["stamps"].append(time.monotonic())
                        rec["tokens"].append(struct.unpack("<I", b)[0])
                except StreamReset as e:
                    rec["end"] = ("stopped" if stop.is_set()
                                  else f"reset {e.code}")
                except Exception as e:  # noqa: BLE001 - recorded, not raised
                    rec["end"] = f"error {type(e).__name__}: {e}"
                finally:
                    st.destroy()
            with lock:
                out.append(rec)
    finally:
        sent.set()
        ch.close()


def main() -> int:
    try:   # die with the run that started this process
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)
    except (OSError, AttributeError):
        pass
    spec = json.loads(sys.stdin.readline())
    mix, seed = spec["mix"], spec["seed"]
    queues = {}
    for req in traffic.serve_requests(mix):
        queues.setdefault(req["client"], []).append(req)
    stop, lock, out = threading.Event(), threading.Lock(), []
    order = sorted(queues)
    sent = {c: threading.Event() for c in order}
    threads = [threading.Thread(target=client,
                                args=(spec["addr"], queues[c], seed,
                                      spec["vocab"], stop, out, lock,
                                      sent[order[i - 1]] if i else None,
                                      sent[c]),
                                daemon=True)
               for i, c in enumerate(order)]
    for t in threads:
        t.start()
    print("started", flush=True)
    sys.stdin.readline()          # "stop", or the end of the input
    stop.set()
    print("ack", flush=True)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = sum(t.is_alive() for t in threads)
    with lock:
        print("RESULT " + json.dumps({"requests": out, "alive": alive}),
              flush=True)
    return 0 if alive == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
