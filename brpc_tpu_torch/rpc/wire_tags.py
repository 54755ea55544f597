"""TRPC meta TLV wire tags — the Python mirror of the registry.

The registry of record is tools/wire_tags_manifest.txt; the C++ side is
the kMetaTag* enum in native/src/rpc.h.  The `wiretags` analyzer rule
(tools/analyze/wiretags.py, tier-1 via tests/test_lint.py) checks all
three against each other BOTH ways, so adding/renaming a tag in one
place fails the gate until the other two agree.

Python never encodes the TRPC meta itself (framing is native), but
tooling that inspects frames — dump utilities, tests asserting
byte-identical wire, future debug decoders — must name tags from here,
never from numeric literals.
"""

METHOD = 1
CORRELATION_ID = 2
ERROR_CODE = 3
ERROR_TEXT = 4
ATTACHMENT_SIZE = 5
COMPRESS_TYPE = 6
TRACE_ID = 7
SPAN_ID = 8
FLAGS = 9
STREAM_ID = 10
STREAM_FRAME_TYPE = 11
FEEDBACK_BYTES = 12
AUTH = 13
DEVICE_CAPS = 14
PLANE_UID = 15
PAYLOAD_CODEC = 16
ATTACH_CODEC = 17
DEADLINE_LEFT_US = 18
