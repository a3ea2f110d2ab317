"""Device-mesh helpers and sequence-parallel attention over ``torch.distributed``.

Counterpart of ``petastorm_tpu/parallel/``: one process per device, a
``DeviceMesh`` of ranks with named dims (:mod:`.mesh`), ring and all-to-all
(Ulysses) attention over its sequence axis (:mod:`.ring_attention`).  The
collectives run over NCCL on the card and gloo on the CPU.  FSDP and the
pipeline are later slices of the port (ROADMAP.md, Queue A item 6).
"""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed, make_mesh, NamedSharding, data_parallel_sharding,
    global_batch_from_local, host_shard_info, sync_hosts, min_over_hosts, epoch_steps,
)
from petastorm_tpu_torch.parallel.ring_attention import (  # noqa: F401
    full_attention, ring_attention, ulysses_attention, make_ring_attention,
    make_ulysses_attention, SeqAxis,
)
