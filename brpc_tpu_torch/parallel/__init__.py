"""parallel/ — distribution layer (port of brpc_tpu/parallel/).

Two halves, mirroring the reference's split between "combo channels" and
the transport underneath:

  mesh.py / collectives.py — named axes over the ranks of a
      torch.distributed process group, and the collectives over one axis
      (NCCL between cards, gloo between CPU processes).  This is the
      layer ParallelChannel and PartitionChannel lower onto when their
      member set is a mesh axis (reference parallel_channel.h:185,
      partition_channel.h:136).
  channels.py — the combo channels themselves (CallMapper /
      ResponseMerger / fail_limit semantics), a copy of the reference's;
      its Mesh* channels ride the collectives above.
  quantize.py — the codec passes of the quantized merge; an int8 pass
      on a CUDA tensor is the kernel of ops/quant_codec.py.
  sharding.py — one rank's shards of a global array and back, and the
      conjugate autograd ops (copy_to / reduce_from / gather_seq / a2a)
      that the sharded model is built from.
  ring_attention.py — ring and Ulysses sequence parallelism; the fold is
      the kernels of ops/ring_fold.py.
"""

from brpc_tpu_torch.parallel.mesh import (  # noqa: F401
    auto_mesh,
    axis_size,
    make_mesh,
)
from brpc_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    bus_bandwidth_gbps,
    reduce_scatter,
    ring_permute,
)
from brpc_tpu_torch.parallel.channels import (  # noqa: F401
    CallMapper,
    DynamicPartitionChannel,
    FirstResponseMerger,
    MeshParallelChannel,
    MeshPartitionChannel,
    ParallelChannel,
    PartitionChannel,
    PartitionParser,
    ResponseMerger,
    SelectiveChannel,
    SubCall,
)
