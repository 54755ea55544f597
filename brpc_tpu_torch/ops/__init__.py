"""ops/ — hand-written CUDA kernels (sources in ../csrc) and the plain
PyTorch version beside each."""

from brpc_tpu_torch.ops.causal_attention import (  # noqa: F401
    CausalAttention,
    causal_attention,
    causal_attention_plain,
)
from brpc_tpu_torch.ops.decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_plain,
)
from brpc_tpu_torch.ops.quant_codec import (  # noqa: F401
    fake_quant_int8,
    fake_quant_int8_plain,
)
from brpc_tpu_torch.ops.ring_fold import (  # noqa: F401
    ring_fold_backward_dkdv,
    ring_fold_backward_dq,
    ring_fold_forward,
    ring_fold_plain,
)
