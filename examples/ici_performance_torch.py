"""ici_performance on the PyTorch/CUDA port (examples/ici_performance.py
on brpc_tpu_torch): bandwidth of the CUDA device plane — raw h2d/d2h
round trips, RPC attachments that round-trip host -> device -> host
through the HbmEcho service on a tpu:// channel, and with --stream the
dev0 -> dev1 rail: d2d hops, then device-payload stream frames.

    python examples/ici_performance_torch.py --device cpu --stream
    python examples/ici_performance_torch.py --stream        # the cards

On the card the plane binds the CUDA driver (libcuda.so.1, or
$TRPC_CUDA_DRIVER); with --device cpu it binds the fake driver
(csrc/cuda_fake.cc, two devices in host memory).  A plane that cannot
start prints the explicit {"available": false, ...} line, as the
reference does, and no figure.

One deliberate difference from the reference: --stream compares the
bytes of every d2d hop and every received frame (each frame carries its
own number) with what was sent, and prints bytes_equal.  Those reads
are neither timed (d2d_gbps and frame_gbps divide by the summed time of
the copies alone) nor counted as host landings: extra_host_copies is the
frames' d2h transfers less the check's own reads (check_reads).

The last stdout line is one JSON object."""

import argparse
import json
import os
import struct
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from brpc_tpu_torch import _native, tpu_plane                # noqa: E402
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions  # noqa: E402
from brpc_tpu_torch.rpc.controller import Controller         # noqa: E402
from brpc_tpu_torch.rpc.server import Server                 # noqa: E402


def _pattern(size: int) -> bytes:
    return bytes(bytearray(range(256)) * (size // 256 + 1))[:size]


def bench_raw(size: int, seconds: float) -> dict:
    """Raw plane h2d + d2h bandwidth (no RPC framing)."""
    data = _pattern(size)
    deadline = time.monotonic() + seconds
    rounds = 0
    t0 = time.monotonic()
    while time.monotonic() < deadline:
        buf = tpu_plane.h2d(data)
        buf.wait()
        back = buf.to_host()
        buf.free()
        assert back == data
        rounds += 1
    dt = time.monotonic() - t0
    return {
        "rounds": rounds,
        "h2d_gbps": rounds * size / dt / 1e9,
        "roundtrip_gbps": 2 * rounds * size / dt / 1e9,
    }


def bench_rpc(size: int, seconds: float) -> dict:
    """Attachment round trips through a real RPC whose server half copies
    host -> device -> host (the HbmEcho service)."""
    server = Server()
    server.add_hbm_echo_service()
    port = server.start("127.0.0.1:0")
    ch = Channel(f"tpu://0/0@127.0.0.1:{port}",
                 ChannelOptions(timeout_ms=60_000, max_retry=0))
    payload = bytes(size)
    before = tpu_plane.stats()
    deadline = time.monotonic() + seconds
    rounds = 0
    t0 = time.monotonic()
    while time.monotonic() < deadline:
        cntl = Controller()
        ch.call("HbmEcho", b"x", attachment=payload, cntl=cntl)
        assert cntl.response_attachment == payload
        rounds += 1
    dt = time.monotonic() - t0
    after = tpu_plane.stats()
    state = ch.transport_state
    ch.close()
    server.destroy()
    return {
        "rounds": rounds,
        "transport": state,
        # each round moves size bytes h2d and size bytes d2h on the server
        "device_gbps": 2 * rounds * size / dt / 1e9,
        "zero_copy_sends": after["zero_copy_sends"] - before["zero_copy_sends"],
        "gather_copies": after["gather_copies"] - before["gather_copies"],
    }


def bench_stream(size: int, seconds: float) -> dict:
    """Tensor stream dev0 -> dev1: device-payload frames over a stream on
    a tpu:// channel.  Both ends share this process's plane, so each frame
    is ONE d2d copy on the local rail; the counters show that no frame
    landed on the host."""
    if tpu_plane.device_count() < 2:
        return {"skipped": "needs 2 addressable devices"}
    server = Server()
    accepted = []
    server.add_service("TensorSink",
                       lambda cntl, req: (accepted.append(
                           cntl.accept_stream()), b"ok")[1])
    port = server.start("127.0.0.1:0")
    ch = Channel(f"tpu://0/0@127.0.0.1:{port}",
                 ChannelOptions(timeout_ms=60_000, max_retry=0))
    _, st = ch.create_stream("TensorSink", b"")
    sink = accepted[0]
    base = _pattern(size)
    mismatched = 0
    check_reads = 0
    # device to device first: one resident source, repeated d2d copies
    # (the source stays valid: a d2d does not consume it)
    src = tpu_plane.h2d(base, device=0)
    src.wait()
    deadline = time.monotonic() + seconds / 2
    hops = 0
    busy = 0.0
    while time.monotonic() < deadline:
        t0 = time.perf_counter()
        dst = tpu_plane.d2d(src, 1)
        dst.wait()           # a hop is done when its copy completed
        busy += time.perf_counter() - t0
        mismatched += dst.to_host() != base
        dst.free()
        hops += 1
    d2d_dt = busy
    src.free()
    # then end-to-end tensor frames (h2d source + stream + d2d per frame),
    # each stamped with its number so a stale frame cannot pass
    before = tpu_plane.stats()
    deadline = time.monotonic() + seconds / 2
    frames = 0
    busy = 0.0
    while time.monotonic() < deadline:
        data = struct.pack("<Q", frames) + base[8:]
        t0 = time.perf_counter()
        buf = tpu_plane.h2d(data, device=0)
        st.write_device(buf)  # ownership transfers
        got = sink.read_device(device=1, timeout_s=60)
        busy += time.perf_counter() - t0
        mismatched += got.to_host() != data
        check_reads += 1
        got.free()
        frames += 1
    after = tpu_plane.stats()
    st.destroy()
    sink.destroy()
    ch.close()
    server.destroy()
    return {
        "d2d_hops": hops,
        "d2d_gbps": hops * size / d2d_dt / 1e9,
        "frames": frames,
        # end-to-end: includes the per-frame source h2d + RPC framing
        "frame_gbps": frames * size / busy / 1e9,
        "d2d_transfers": after["d2d_transfers"] - before["d2d_transfers"],
        "gather_copies": after["gather_copies"] - before["gather_copies"],
        # host landings beyond the unavoidable source h2d per frame
        "extra_host_copies": (after["d2h_transfers"] -
                              before["d2h_transfers"] - check_reads),
        "check_reads": check_reads,
        "bytes_checked": (hops + frames) * size,
        "bytes_equal": mismatched == 0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size-mb", type=float, default=8.0)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--stream", action="store_true",
                    help="also run the dev0->dev1 tensor-stream bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the fake CUDA driver's two devices")
    args = ap.parse_args(argv)
    size = int(args.size_mb * 1024 * 1024)

    driver = _native.build_fake_driver() if args.device == "cpu" else None
    if not tpu_plane.init(driver):
        print(json.dumps({
            "available": False,
            "fallback": "tcp",
            "reason": tpu_plane.error(),
        }))
        return 0
    out = {
        "available": True,
        "platform": tpu_plane.platform(),
        "device": args.device,
        "devices": tpu_plane.device_count(),
        "size_mb": args.size_mb,
        "raw": bench_raw(size, args.seconds),
        "rpc": bench_rpc(size, args.seconds),
    }
    if args.stream:
        out["stream"] = bench_stream(size, args.seconds)
    out["live_buffers_end"] = tpu_plane.stats()["live_buffers"]
    print(json.dumps(out))
    return 0 if out.get("stream", {}).get("bytes_equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
