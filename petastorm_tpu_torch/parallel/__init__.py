"""Device-mesh helpers and model parallelism over ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel/``: one process per device, a
``DeviceMesh`` of ranks with named dims (:mod:`.mesh`), ring and all-to-all
(Ulysses) attention over its sequence axis (:mod:`.ring_attention`), the
GPipe pipeline (:mod:`.pipeline`), FSDP's sharding rules (:mod:`.fsdp`),
and the placement that makes a model compute with its blocks
(:mod:`.placement`, over the differentiable collectives of
:mod:`.collectives`).  The collectives run over NCCL on the card and gloo
on the CPU.
"""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed, make_mesh, NamedSharding, data_parallel_sharding,
    global_batch_from_local, host_shard_info, sync_hosts, min_over_hosts, epoch_steps,
)
from petastorm_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention, ring_attention, ulysses_attention, make_ring_attention,
    make_ulysses_attention, SeqAxis,
)
from petastorm_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply, make_pipeline,
)
from petastorm_tpu_torch.parallel.fsdp import (  # noqa: F401
    fsdp_shardings, fsdp_size_report,
)
from petastorm_tpu_torch.parallel.placement import (  # noqa: F401
    place, device_put, local_blocks, reduce_gradients,
)
