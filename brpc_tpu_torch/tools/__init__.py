"""Operator tools (≙ the reference tools/ suite, SURVEY.md §2.7):

    python -m brpc_tpu_torch.tools.rpc_press     — load generator (≙ rpc_press)
    python -m brpc_tpu_torch.tools.rpc_replay    — replay rpc_dump samples
    python -m brpc_tpu_torch.tools.rpc_view      — proxy a remote builtin portal
    python -m brpc_tpu_torch.tools.parallel_http — mass concurrent HTTP fetch

Each module also exposes a callable API used by the tests.
"""
