"""Distributed runtime of the port (counterpart of
``unicore_tpu/distributed/``): one rank per card in a
``torch.distributed`` process group (gloo on the CPU), the ZeRO-1 leaf
rule and the ``--comms-overlap`` bucket layout as pure functions of the
flax tree, and the trainer's collectives (:mod:`.data_parallel`)."""

from .utils import (  # noqa: F401
    all_gather_objects,
    backend_for,
    call_main,
    comm_bucket_assignment,
    distributed_init,
    get_data_parallel_rank,
    get_data_parallel_world_size,
    zero1_dim,
    zero1_slice,
)
