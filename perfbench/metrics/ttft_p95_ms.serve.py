"""ttft_p95_ms.serve: the 95th percentile of time to first token (first
token's stamp minus the request's send, client side) over every request
completed in the window, in ms."""

from perfbench.stats import completed_in_window, p95


def read(rec):
    v = p95([r["stamps"][0] - r["t_send"] for r in completed_in_window(rec)])
    return None if v is None else v * 1e3
