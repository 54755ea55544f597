"""models/ — the transformer LM (dense and MoE), its KV-cached decode and
its training step, on PyTorch (port of brpc_tpu/models/ on one device;
the sequence-parallel attention paths and the mesh argument are not
ported yet)."""

from brpc_tpu_torch.models.transformer import (  # noqa: F401
    ModelConfig,
    TransformerLM,
    apply,
    init,
)
from brpc_tpu_torch.models.decode import (  # noqa: F401
    decode_step,
    init_cache,
    prefill,
)
from brpc_tpu_torch.models.train import (  # noqa: F401
    TrainState,
    loss_fn,
    make_train_step,
)
