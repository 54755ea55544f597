"""models/ — the transformer LM (dense and MoE), its KV-cached decode,
its training step and its checkpoints, on PyTorch (port of
brpc_tpu/models/): on one device, or over a mesh with this rank's shards
(``mesh=``: training and serving's prefill, decode step and cache)."""

from brpc_tpu_torch.models.transformer import (  # noqa: F401
    ModelConfig,
    TransformerLM,
    apply,
    init,
    param_specs,
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
