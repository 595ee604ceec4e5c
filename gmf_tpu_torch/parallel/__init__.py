"""Meshes of ranks and the collectives over them, on torch.distributed.

Counterpart of ``gmf_tpu/parallel/``:

- ``mesh.py``: the ('data', 'model') mesh over a process group; 'data'
  is the primary axis (independent registration pairs per rank), 'model'
  only replicates. ``shard_batch``, ``replicate``, ``process_shard`` and
  the ``sharded`` step context.
- ``ring_attention.py``: compat attention with the tokens split over the
  ring, for megapairs.
- ``collectives.py``: the sums, all-gathers and ring hops that XLA
  inserts for gmf_tpu, explicit here.
- ``launch.py``: spawn a world of N ranks, or join one under
  ``torchrun``.
"""

from gmf_tpu_torch.parallel.mesh import (
    Mesh,
    batch_mesh,
    data_parallel_shardings,
    make_mesh,
    process_shard,
    replicate,
    shard_batch,
    sharded,
)
