"""Process groups, the ZeRO-1 leaf rule and the bucket layout of the
port (counterpart of ``unicore_tpu/distributed/utils.py``).

The JAX package runs one process per host over a mesh of every device;
here, as in the reference Uni-Core, each card is a rank of its own in a
``torch.distributed`` process group: NCCL on the card, gloo when the
caller asked for the CPU (``--distributed-backend``'s default ``xla``,
the JAX package's value, means "the device's own collectives").

- :func:`distributed_init` wraps ``init_process_group``; an explicit
  ``--distributed-init-method`` with a missing or wrong world size or rank
  fails there, never as a silent single-process run.
- :func:`call_main` is the entry point: without an init method it spawns
  one process per visible card (``--distributed-world-size`` of them on
  the CPU), each bound to its card (``--device-id``/``--local_rank``);
  ranks other than 0 log at WARNING.
- :func:`zero1_slice` is the JAX ``_leaf_spec`` rule of ``--zero1`` on a
  ``data`` axis of the world size, for one leaf of the flax tree: the
  largest dimension that the world divides is split in equal contiguous
  slices, rank r owning slice r, as ``zero1_sharding`` gives device r of
  a ``data`` mesh; leaves of one or no dimension stay replicated.
- :func:`comm_bucket_assignment` is the JAX function's greedy sweep over
  the leaves in the canonical (sorted-key) order of the flax tree.
"""

import logging
import os
import pickle
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(args):
    if getattr(args, "cpu", False):
        return "cpu"
    return torch.device(getattr(args, "device", "cuda") or "cuda").type


def backend_for(args):
    """The process group's backend: ``--distributed-backend`` as given,
    or for its default ``xla`` (the JAX package's: the device's own
    collectives) NCCL on the card and gloo on the CPU."""
    backend = getattr(args, "distributed_backend", None) or "xla"
    if backend == "xla":
        return BACKENDS[_device_type(args)]
    return backend


def _init_method(args):
    method = getattr(args, "distributed_init_method", None)
    coordinator = getattr(args, "coordinator_address", None)
    if method is None and coordinator:
        method = "tcp://" + coordinator.replace("tcp://", "")
    return method


def _world_size(args):
    world = getattr(args, "distributed_world_size", None)
    if world is None:
        world = getattr(args, "num_processes", None)
    return world


def distributed_init(args):
    """Join the process group ``args`` names; returns this process's rank.

    ``--distributed-init-method`` (``tcp://host:port``, ``file://...`` or
    ``env://``; or ``--coordinator-address host:port``) with
    ``--distributed-world-size`` and ``--distributed-rank`` (or
    ``--num-processes``/``--process-id``) joins exactly that group: a
    wrong value raises or times out in ``init_process_group``.  Without an
    init method a world size above 1 is a misconfiguration (this process
    could reach no peer); a world of one runs without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    method = _init_method(args)
    world = _world_size(args)
    if method is None:
        if world not in (None, 1):
            raise ValueError(
                f"--distributed-world-size {world} needs "
                "--distributed-init-method (or call_main, which spawns "
                "the ranks and names their rendezvous)")
        return 0
    rank = getattr(args, "distributed_rank", 0)
    if getattr(args, "process_id", None) is not None:
        rank = args.process_id
    if method.startswith("env://"):
        world = int(os.environ.get("WORLD_SIZE", world or 0)) or None
        rank = int(os.environ.get("RANK", rank))
    if world is None or rank is None or not 0 <= rank < world:
        raise ValueError(
            f"distributed init {method!r} needs a world size and a rank "
            f"in [0, world): got --distributed-world-size {world}, "
            f"--distributed-rank {rank}")
    backend = backend_for(args)
    logger.info("distributed init (rank %d of %d): %s over %s", rank, world,
                method, backend)
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank)
    args.distributed_world_size = world
    args.distributed_rank = rank
    return rank


def get_data_parallel_rank():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_data_parallel_world_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def collective_device():
    """Where the group's collectives take their tensors: this rank's card
    under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj, max_size=16384):
    """One picklable host object from every rank, as a list ordered by
    rank (the reference's ``all_gather_list``): each rank's pickle, at
    most ``max_size`` bytes (``--all-gather-list-size``), rides a byte
    buffer of that size.  One process: ``[obj]``, no communication."""
    world = get_data_parallel_world_size()
    if world == 1:
        return [obj]
    payload = pickle.dumps(obj)
    if len(payload) > max_size:
        raise ValueError(
            f"all_gather_objects: {len(payload)} pickled bytes exceed "
            f"--all-gather-list-size {max_size}")
    device = collective_device()
    buf = torch.zeros(max_size + 8, dtype=torch.uint8)
    buf[:8] = torch.frombuffer(bytearray(
        np.int64(len(payload)).tobytes()), dtype=torch.uint8)
    buf[8:8 + len(payload)] = torch.frombuffer(bytearray(payload),
                                               dtype=torch.uint8)
    out = torch.empty(world * (max_size + 8), dtype=torch.uint8,
                      device=device)
    dist.all_gather_into_tensor(out, buf.to(device))
    table = out.cpu().numpy().reshape(world, max_size + 8)
    return [pickle.loads(row[8:8 + int(row[:8].view(np.int64)[0])]
                         .tobytes()) for row in table]


def free_port():
    """A free TCP port on localhost for a spawned group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_main(index, main, args, kwargs):
    """A spawned rank: bind its card, join the group, run ``main``."""
    from ..utils import import_user_module

    # a spawned interpreter has run no plugin registration and has no
    # log handler yet (the CLI's format)
    import_user_module(getattr(args, "user_dir", None))
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    args.device_id = index
    args.distributed_rank = getattr(args, "distributed_rank", 0) + index
    distributed_main(main, args, **kwargs)


def distributed_main(main, args, **kwargs):
    """Bind this process to ``--device-id`` on the card, join the group,
    quiet the logs of ranks other than 0, run ``main(args)``; the group is
    left on the way out."""
    if _device_type(args) == "cuda":
        torch.cuda.set_device(args.device_id)
        args.device = f"cuda:{args.device_id}"
    rank = distributed_init(args)
    if rank != 0:
        # non-master ranks log at WARNING (reference utils.py:142-145)
        logging.getLogger("unicore_tpu_torch").setLevel(logging.WARNING)
    args.distributed_rank = rank
    try:
        return main(args, **kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def call_main(args, main, **kwargs):
    """Run ``main(args)`` on every rank (parity: ``distributed_utils.
    call_main``).  A world of one runs in this process, as before.  With
    ``--distributed-init-method`` (or ``--distributed-no-spawn``, for a
    launcher such as torchrun that started the ranks) this process is one
    rank.  Otherwise it spawns ``--distributed-world-size`` ranks (default:
    every visible card; on the CPU it must be given) on this host, over
    ``tcp://localhost:<--distributed-port or a free port>``, and returns
    once all of them have (a rank that fails fails the call)."""
    world = _world_size(args)
    if world is None:
        world = (torch.cuda.device_count() if _device_type(args) == "cuda"
                 else 1)
    data_parallel = getattr(args, "data_parallel_size", -1)
    if data_parallel not in (None, -1) and data_parallel != world:
        raise ValueError(
            f"--data-parallel-size {data_parallel} is not the world size "
            f"{world}: every rank is one data-parallel replica")
    if _init_method(args) is not None or getattr(args, "distributed_no_spawn",
                                                 False):
        if _init_method(args) is None:
            # a launcher's group: its environment names rank and card
            args.distributed_init_method = "env://"
            args.device_id = int(os.environ.get("LOCAL_RANK",
                                                args.device_id))
        args.distributed_world_size = world
        return distributed_main(main, args, **kwargs)
    if world <= 1:
        args.distributed_world_size = 1
        return main(args, **kwargs)
    nprocs = getattr(args, "nprocs_per_node", None) or world
    if nprocs != world:
        raise ValueError(
            f"--nprocs-per-node {nprocs} != world size {world}: a spawn "
            "starts every rank on this host; start other hosts' ranks "
            "with --distributed-init-method")
    port = getattr(args, "distributed_port", -1)
    args.distributed_init_method = (
        f"tcp://localhost:{port if port > 0 else free_port()}")
    args.distributed_world_size = world
    args.distributed_rank = 0
    torch.multiprocessing.spawn(_spawned_main, args=(main, args, kwargs),
                                nprocs=world, join=True)
    return None


# ----------------------------------------------------------------------
# the ZeRO-1 leaf rule and the bucket layout: pure functions of the flax
# tree's paths and shapes
# ----------------------------------------------------------------------

def zero1_dim(shape, world):
    """The dimension of a leaf of ``shape`` that ``--zero1`` splits over
    ``world`` ranks, or None (replicated): the JAX ``_leaf_spec`` rule on
    a ``data`` axis of that size with no tensor axis — the largest
    dimension (the first of equals) of at least ``world`` elements that
    ``world`` divides; a leaf of fewer than two dimensions replicates."""
    if world <= 1 or len(shape) < 2:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] >= world and shape[d] % world == 0:
            return d
    return None


def zero1_slice(name, shape, world, rank):
    """``(dim, start, stop)``: the slice of the leaf ``name`` (its flax
    path; the tensor axis's name rules are A13's, so only the shape
    decides here) of ``shape`` that rank ``rank`` of ``world`` owns under
    ``--zero1``; None for a replicated leaf."""
    del name
    d = zero1_dim(tuple(shape), world)
    if d is None:
        return None
    n = shape[d] // world
    return d, rank * n, (rank + 1) * n


def tree_items(tree, prefix=()):
    """``(path, leaf)`` of a nested dict in JAX's canonical flatten order
    (keys sorted at every level)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from tree_items(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _itemsize(leaf):
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def comm_bucket_assignment(tree, bucket_bytes):
    """Leaf -> bucket id, the JAX function's greedy sweep: in canonical
    order leaves fill bucket 0 until the next leaf would push its bytes
    past ``bucket_bytes``, then bucket 1, and so on; a leaf larger than
    the cap gets a bucket to itself.  ``tree`` is a nested dict whose
    leaves have a shape and a dtype (numpy, torch or JAX arrays).
    Returns ``(ids, n_buckets)``, ``ids`` a nested dict of the same keys."""
    ids, bucket, used = {}, 0, 0
    for path, leaf in tree_items(tree):
        nbytes = int(np.prod(getattr(leaf, "shape", ()), dtype=np.int64)) \
            * _itemsize(leaf)
        if used and used + nbytes > bucket_bytes:
            bucket, used = bucket + 1, 0
        node = ids
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = bucket
        used += nbytes
    if not ids:
        return tree, 0
    return ids, bucket + 1
