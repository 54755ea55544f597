"""Package rules of the port (brpc_tpu_torch/, chip_smoke.py).

* It imports neither jax nor the reference package, statically (an AST
  scan of every module) and at run time (a process that serves a request
  has no jax module and no reference core mapped).
* The host modules carried over from the reference are copies: each
  equals, byte for byte, what ``carry`` makes of its reference (the
  package prefix rewritten, the reference's ``ISSUE n`` tags dropped, and
  one comment's example path made generic).  The port's own modules are
  listed; a module in neither list fails the scan.
* Entry points run on the card unless the caller asks for the CPU: with
  no card they raise, and chip_smoke.py fails without printing a result.
"""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from brpc_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "brpc_tpu_torch")

# carried verbatim from brpc_tpu/ (prefix rewritten), pinned below
COPIED = (
    ["__init__.py", "fiber/__init__.py",
     "utils/__init__.py", "utils/flags.py", "utils/logging.py",
     "utils/endpoint.py", "utils/doubly_buffered.py", "utils/recordio.py",
     "metrics/__init__.py", "metrics/bvar.py", "metrics/collector.py",
     "metrics/default_vars.py", "metrics/dumper.py", "metrics/native.py",
     "builtin/__init__.py", "builtin/flame.py", "builtin/portal.py",
     "utils/checksum.py", "utils/timeutil.py",
     "parallel/channels.py"]
    + [f"cluster/{m}.py" for m in (
        "__init__", "circuit_breaker", "cluster_channel", "health_check",
        "limiter", "load_balancer", "membership", "naming")]
    + [f"rpc/{m}.py" for m in (
        "__init__", "errors", "controller", "channel", "server", "stream",
        "codec", "compress", "dump", "http", "http_client", "auth",
        "_sockutil", "grpc_service", "pb_service", "redis_service",
        "thrift", "altpack", "h2_client", "memcache", "mongo",
        "wire_tags")]
    + [f"tools/{m}.py" for m in (
        "__init__", "parallel_http", "rpc_press", "rpc_replay",
        "rpc_view")])

# the port's own modules: rewritten counterparts of reference modules
# (_native, tpu_plane, models, parallel, serving/engine; rpc/span and
# serving/scheduler, which time the serving engine's stages on the
# monotonic clock; serving/kv_cache, whose blocks are filled and read on
# the device) and new ones
PORTED = [
    "_native/__init__.py", "tpu_plane.py", "weights.py", "entry.py",
    "models/__init__.py", "models/transformer.py", "models/decode.py",
    "models/train.py", "models/checkpoint.py", "models/moe.py",
    "models/lfm2.py",
    "ops/__init__.py", "ops/decode_attention.py", "ops/causal_attention.py",
    "ops/quant_codec.py", "ops/ring_fold.py",
    "parallel/__init__.py", "parallel/quantize.py", "parallel/mesh.py",
    "parallel/collectives.py", "parallel/sharding.py",
    "parallel/ring_attention.py",
    "serving/__init__.py", "serving/engine.py", "serving/lockstep.py",
    "serving/scheduler.py", "serving/kv_cache.py", "rpc/span.py",
]


def _port_modules():
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("build",
                                                         "__pycache__")]
        out += [os.path.relpath(os.path.join(dirpath, f), PKG)
                for f in filenames if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_no_module_imports_jax_or_the_reference():
    files = [os.path.join(PKG, m) for m in _port_modules()]
    files += [os.path.join(REPO, f) for f in ("chip_smoke.py",
                                              "bench_torch.py")]
    files += sorted(glob.glob(os.path.join(REPO, "examples", "*_torch.py")))
    bad = [f"{os.path.relpath(f, REPO)}:{line} imports {root}"
           for f in files for root, line in _imported_roots(f)
           if root in ("jax", "jaxlib", "brpc_tpu")]
    assert bad == []


def test_every_module_is_a_pinned_copy_or_a_port():
    assert sorted(COPIED + PORTED) == _port_modules()


# The copies leave out the reference's "ISSUE n" tags.  A tag that opens
# a parenthesis: "x (ISSUE n): y" -> "x: y", "(ISSUE n) y" -> "y"; and
# "(ISSUE n, x" or "(ISSUE n; x" keep the parenthesis, the blank after
# the tag (a line break too) moving in front of it.
_OPENING_TAG = re.compile(r" ?\(ISSUE \d+(?P<sep>[,;)])(?P<ws>\s*)")
# A tag that closes one: "(x, ISSUE n): y" -> "(x): y"; a line break
# inside the tag moves after the "):" and takes the blank's place.
_CLOSING_TAG = re.compile(
    r",(?P<tag>\s*(?:#\s*)?ISSUE\s+\d+)\)(?P<colon>:?)(?P<blank> ?)")
# A tag that is a noun of its sentence becomes the header it added.
_NOUN_TAG = re.compile(r"\bISSUE 11\b")
# The one comment that named an absolute path of the reference's checkout
# (portal.py's base-directory check) names it generically.
_EXAMPLE_PATH = re.compile(r"(/\w+/\w+)-secrets beside \1\b")


def _drop_opening_tag(m):
    return m["ws"] + ("" if m["sep"] == ")" else "(")


def _drop_closing_tag(m):
    brk = re.search(r"\n[ \t]*(?:#[ \t]*)?", m["tag"])
    return ")" + m["colon"] + (brk.group(0) if brk else m["blank"])


def carry(text: str) -> str:
    """What a copied host module is made of its reference's text."""
    text = re.sub(r"\bbrpc_tpu\b", "brpc_tpu_torch", text)
    text = _OPENING_TAG.sub(_drop_opening_tag, text)
    text = _CLOSING_TAG.sub(_drop_closing_tag, text)
    text = _NOUN_TAG.sub("overload.h", text)
    return _EXAMPLE_PATH.sub("a sibling dir like <base>-secrets", text)


def test_carry_rewrites_only_tags_and_the_example_path():
    code = "x = f(1)  # ISSUE\n"              # no tag form: left as it is
    assert carry(code) == code
    assert carry("a (ISSUE 19): b (c, ISSUE 8) d") == "a: b (c) d"
    assert carry("import brpc_tpu.rpc") == "import brpc_tpu_torch.rpc"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_host_module_equals_its_reference(rel):
    with open(os.path.join(REPO, "brpc_tpu", rel)) as f:
        want = carry(f.read())
    with open(os.path.join(PKG, rel)) as f:
        assert f.read() == want, f"{rel} drifted from brpc_tpu/{rel}"


RUNTIME_CODE = r"""
import sys
from brpc_tpu_torch import tpu_plane
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import Server
from brpc_tpu_torch.serving import ServingEngine

assert tpu_plane.init(), tpu_plane.error()
srv = Server()
srv.add_hbm_echo_service()
srv.start("127.0.0.1:0")
ch = Channel(f"tpu://0/0@127.0.0.1:{srv.port}",
             ChannelOptions(max_retry=0, timeout_ms=30000))
cntl = Controller()
assert ch.call("HbmEcho", b"ping", attachment=b"x" * 65536,
               cntl=cntl) == b"ping"
assert cntl.response_attachment == b"x" * 65536
assert ch.transport_state == "device", ch.transport_state
ch.close()
srv.destroy()
maps = open("/proc/self/maps").read()
assert "libbrpc_tpu_torch_core.so" in maps
assert "libbrpc_tpu_core.so" not in maps, "the reference core is mapped"
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not [m for m in sys.modules
            if m == "brpc_tpu" or m.startswith("brpc_tpu.")]
print("RUNTIME-OK")
"""


def test_a_serving_process_loads_neither_jax_nor_the_reference_core():
    _native.build_core()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TRPC_CUDA_DRIVER"] = _native.build_fake_driver()
    r = subprocess.run([sys.executable, "-c", RUNTIME_CODE], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0 and "RUNTIME-OK" in r.stdout, \
        r.stdout + r.stderr


MESH_MODULES = ("brpc_tpu_torch.entry", "brpc_tpu_torch.parallel.sharding",
                "brpc_tpu_torch.parallel.ring_attention",
                "brpc_tpu_torch.ops.ring_fold", "brpc_tpu_torch.models.train",
                "brpc_tpu_torch.models.checkpoint", "brpc_tpu_torch.weights")


def test_the_mesh_modules_load_neither_jax_nor_the_reference():
    code = ("import importlib, sys\n"
            f"for m in {MESH_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'brpc_tpu')]\n"
            "assert not bad, bad\n"
            "print('MESH-OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "MESH-OK" in r.stdout, r.stdout + r.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    from brpc_tpu_torch.models import decode, transformer
    from brpc_tpu_torch.ops import decode_attention, fake_quant_int8
    from brpc_tpu_torch.parallel import auto_mesh, make_mesh
    from brpc_tpu_torch.serving.engine import ServingEngine, tiny_config
    from brpc_tpu_torch.serving.kv_cache import KvBlockPlane

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, kv=KvBlockPlane(block_bytes=4096, n_blocks=4,
                                           decode_device=0))
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        auto_mesh(1)
    from brpc_tpu_torch import entry
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        entry.dryrun_multichip(1)
    assert make_mesh({"dp": 1}, device_type="cpu").shape == {"dp": 1}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fake_quant_int8(torch.empty(4, device="meta"))
    meta = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(meta, meta, meta,
                         torch.empty(1, 8, 4, 16, device="meta"),
                         torch.empty(1, 8, 4, 16, device="meta"),
                         torch.empty(1, dtype=torch.int32, device="meta"))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.cuda
def test_chip_smoke_passes_on_the_card():
    """The whole chip check (build, plane, transport, kernel, serving)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernels")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
