"""Data parallelism of the port's trainer: the gradient's reduction across
ranks, ZeRO-1's slices and ``--comms-overlap``'s buckets (the collectives
that the JAX step's sharding constraints make XLA emit,
``unicore_tpu/trainer.py`` ``_make_train_step``).

Every leaf is placed by its flax path and shape (:class:`Leaf`), so both
packages agree on it: its ZeRO-1 slice is the one ``zero1_sharding``
gives device r of a ``data`` mesh (:func:`~.utils.zero1_slice`), and its
bucket is ``comm_bucket_assignment``'s over the flax tree's canonical
order.  A flax leaf is a view of the port's tensor (a transpose or a
reshape of it, ``examples/*/convert.py``); its dimensions, ordered by
their strides in the port's tensor, are the port tensor's own row-major
dimensions, so a slice of a flax dimension is, in the port's memory,
runs of equal length a fixed stride apart.  A rank keeps its slice flat,
in the port's element order: the optimizer and the EMA step on it
elementwise, and its stochastic rounding (``ops/rounding.py`` windows)
draws the bits the whole leaf's elements would draw.

:class:`DataParallel` runs one update's communication:

- **Plain DP**: each bucket's fp32 master gradients are summed across
  ranks by one all-reduce, issued from the gradient hooks as the
  bucket's last gradient lands in the micro-batch group's last backward,
  so the reduction overlaps the rest of the backward.
- **--zero1** (world > 1): the gradient is reduce-scattered to the
  ranks' slices after the backward (one bucket, as the JAX step's one
  constraint), the optimizer steps on the slices (replicated leaves,
  those of fewer than two dimensions, whole on every rank), and the
  updated slices are all-gathered back into the replicated params.
- **--comms-overlap** (with --zero1): the master params and the EMA are
  the slices; each bucket is reduce-scattered from the hooks; at the top
  of an update only the compute copy is gathered (bf16 bytes under
  ``--bf16``), bucket by bucket.

The sample size and the logging outputs are summed across ranks, and
the gradient norm is taken over the global gradient (over slices: the
slices' squares summed across ranks, each replicated leaf counted once),
so every rank takes the same overflow verdict and the same update.  A
collective that the backend does not take for the tensors' device raises
:class:`CollectiveError`, naming it; nothing is staged through another
device instead.
"""

import logging
import time

import torch
import torch.distributed as dist

from ..ops.prng import draw_seeds
from ..ops.rounding import fp32_to_bf16_sr_multi
from .utils import (comm_bucket_assignment, get_data_parallel_rank,
                    get_data_parallel_world_size, tree_items, zero1_slice)

logger = logging.getLogger(__name__)

# seconds spent waiting on collectives, and their count, since the last
# reset (read by the smoke's data_parallel phase)
comm_stats = {"seconds": 0.0, "calls": 0}


class CollectiveError(RuntimeError):
    """The process group's backend refused a collective for these
    tensors (gloo and CUDA tensors, for some collectives)."""


def _collective(name, fn, *tensors, **kwargs):
    try:
        return fn(*tensors, **kwargs)
    except (RuntimeError, ValueError) as e:
        raise CollectiveError(
            f"{name} on {tensors[0].device.type} {tensors[0].dtype} tensors "
            f"failed on the {dist.get_backend()} backend: {e}") from e


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class Leaf:
    """One master parameter: its flax path and layout, and its ZeRO-1
    slice on this rank.

    ``order`` lists the flax dimensions by descending stride in the port
    tensor; the port tensor viewed as ``sorted_shape`` (the flax shape in
    that order) is itself, and ``permute(back)`` of that view is the flax
    leaf.  Sharded along flax dim ``dim`` (``k`` in sorted order), rank r
    owns ``view.narrow(k, r·c, c)``: elements ``origin + j·stride +
    [0, span)`` of the port tensor, kept flat in that order."""

    def __init__(self, index, name, path, shape, view, world, rank):
        self.index, self.name, self.path = index, name, tuple(path)
        self.shape = tuple(shape)
        self.numel = _numel(self.shape)
        self.flax_shape = tuple(view.shape)
        strides = view.stride()
        self.order = sorted(range(view.dim()), key=lambda d: -strides[d])
        self.back = tuple(sorted(range(view.dim()),
                                 key=lambda d: self.order[d]))
        self.sorted_shape = tuple(self.flax_shape[d] for d in self.order)
        expect = 1
        for d in reversed(self.order):
            if self.flax_shape[d] > 1 and strides[d] != expect:
                raise NotImplementedError(
                    f"{name}: its flax layout is not a permutation of the "
                    "port tensor's dimensions, so it has no ZeRO-1 slices")
            expect *= self.flax_shape[d]
        spec = zero1_slice(self.path, self.flax_shape, world, rank)
        self.sharded = spec is not None
        if not self.sharded:
            return
        self.dim, start, stop = spec
        self.k = self.order.index(self.dim)
        self.c = stop - start
        inner = _numel(self.sorted_shape[self.k + 1:])
        self.span = self.c * inner
        self.stride = self.sorted_shape[self.k] * inner
        self.slice_numel = self.numel // world
        self.slice_shape = (self.sorted_shape[:self.k] + (self.c,)
                            + self.sorted_shape[self.k + 1:])
        self.rank = rank

    def window(self, r=None):
        """Rank r's slice's window in its leaf, as ``ops/rounding.py``
        takes it: ``(leaf numel, origin, span, stride)``."""
        r = self.rank if r is None else r
        return (self.numel, r * self.span, self.span, self.stride)

    def flax_index(self, r=None):
        """The JAX package's key of rank r's piece (``_norm_index``)."""
        r = self.rank if r is None else r
        return tuple((r * self.c, (r + 1) * self.c) if d == self.dim
                     else (0, n) for d, n in enumerate(self.flax_shape))

    def region(self, t, r=None):
        """Rank r's slice of the port tensor ``t`` (a strided view)."""
        r = self.rank if r is None else r
        return t.view(self.sorted_shape).narrow(self.k, r * self.c, self.c)

    def take(self, t, r=None):
        """Rank r's slice of ``t``, flat and contiguous (a copy)."""
        return self.region(t, r).reshape(-1).clone()

    def to_flax(self, t):
        """The port tensor ``t`` (or a flat slice of it) in the flax
        layout, as a view."""
        shape = self.slice_shape if t.numel() != self.numel else \
            self.sorted_shape
        return t.reshape(shape).permute(self.back)

    def from_flax(self, a, piece):
        """A flax-layout array (the whole leaf, or with ``piece`` this
        rank's piece of it) -> the port's tensor, or its flat slice."""
        t = torch.as_tensor(a).permute(self.order)
        if piece:
            return t.reshape(-1)
        return t.reshape(self.shape)


def leaf_layouts(model, world, rank):
    """:class:`Leaf` of every trainable parameter of ``model``, in
    parameter order (the model's converter gives the flax paths and
    layouts; meta tensors, so nothing is copied)."""
    named = {n: torch.empty(p.shape, device="meta")
             for n, p in model.named_parameters() if p.requires_grad}
    found = {name: (path, view)
             for name, path, view in model.flax_items(named)}
    return [Leaf(i, n, found[n][0], named[n].shape, found[n][1], world,
                 rank) for i, n in enumerate(named)]


class DataParallel:
    """The collectives of one rank's updates (see the module's notes).

    ``masters``: the fp32 master params in parameter order;
    ``compute``: the compute copy's params (the masters themselves in
    fp32), whose gradients the backward fills."""

    def __init__(self, model, compute_model, zero1=False, overlap=False,
                 bucket_bytes=4 << 20):
        self.world = get_data_parallel_world_size()
        self.rank = get_data_parallel_rank()
        self.masters = [p for p in model.parameters() if p.requires_grad]
        self.compute = [p for p in compute_model.parameters()
                        if p.requires_grad]
        self.fold = compute_model is not model
        self.zero1 = bool(zero1) and self.world > 1
        self.overlap = bool(overlap) and self.zero1
        self.leaves = leaf_layouts(model, self.world, self.rank)
        tree = {}
        for leaf in self.leaves:
            node = tree
            for key in leaf.path[:-1]:
                node = node.setdefault(key, {})
            node[leaf.path[-1]] = torch.empty(leaf.flax_shape,
                                              device="meta")
        if self.zero1 and not self.overlap:
            bucket_bytes = float("inf")  # the JAX step's one constraint
        ids, n = comm_bucket_assignment(tree, bucket_bytes)
        by_path = {leaf.path: leaf.index for leaf in self.leaves}
        self.buckets = [[] for _ in range(n)]
        for path, b in tree_items(ids):
            self.buckets[b].append(by_path[path])
        self.bucket_of = [0] * len(self.leaves)
        for b, members in enumerate(self.buckets):
            for i in members:
                self.bucket_of[i] = b
        # ZeRO-1: this rank's slices, flat fp32 (the optimizer's params;
        # under --comms-overlap the master params themselves)
        self.shards = {}
        if self.zero1:
            for leaf in self.leaves:
                if leaf.sharded:
                    self.shards[leaf.index] = leaf.take(
                        self.masters[leaf.index].detach()).requires_grad_()
        self._armed = False
        self._pending = {}
        self._hooks = []
        if not self.zero1 or self.overlap:
            for i, p in enumerate(self.compute):
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    self._hook(i)))
        logger.info(
            "data parallel: rank %d of %d, %s, %d param leaves in %d "
            "bucket(s)", self.rank, self.world,
            "--zero1 --comms-overlap" if self.overlap
            else "--zero1" if self.zero1 else "all-reduce",
            len(self.leaves), len(self.buckets))

    # -- layout --------------------------------------------------------

    def optimizer_params(self):
        """What the optimizer steps on, in parameter order: a sharded
        leaf's slice under ZeRO-1, else the master param."""
        return [self.shards.get(i, p) for i, p in enumerate(self.masters)]

    def sr_windows(self):
        """Per optimizer param, its window in its leaf (None: whole)."""
        if not self.zero1:
            return None
        return [leaf.window() if leaf.sharded else None
                for leaf in self.leaves]

    def master_tensors(self):
        """The master weights as this rank holds them: the slices under
        --comms-overlap, else the full params."""
        if self.overlap:
            return self.optimizer_params()
        return list(self.masters)

    # -- the backward's hooks and the gradient's reduction --------------

    def arm(self):
        """The next backward is the micro-batch group's last: its hooks
        launch each bucket's reduction as the bucket completes."""
        self._armed = True
        self._ready = [0] * len(self.buckets)

    def _hook(self, i):
        def hook(param):
            if not self._armed:
                return
            if self.fold:
                self._fold(i)
            b = self.bucket_of[i]
            self._ready[b] += 1
            if self._ready[b] == len(self.buckets[b]):
                self._launch(b)
        return hook

    @torch.no_grad()
    def _fold(self, i):
        m, c = self.masters[i], self.compute[i]
        if c.grad is None:
            return
        if m.grad is None:
            m.grad = c.grad.float()
        else:
            m.grad += c.grad
        c.grad = None

    def _grad(self, i):
        m = self.masters[i]
        if m.grad is None:  # a leaf the group's batches did not reach
            m.grad = torch.zeros_like(m)
        return m.grad

    @torch.no_grad()
    def _launch(self, b):
        members = self.buckets[b]
        replicated = [i for i in members if i not in self.shards]
        sharded = [i for i in members if i in self.shards]
        work = []
        if replicated:
            flat = torch.cat([self._grad(i).reshape(-1) for i in replicated])
            work.append(("all_reduce", replicated, flat, _collective(
                "all_reduce", dist.all_reduce, flat, async_op=True)))
        if sharded:
            chunk = sum(self.leaves[i].slice_numel for i in sharded)
            buf = torch.empty(self.world * chunk, dtype=torch.float32,
                              device=self.masters[sharded[0]].device)
            for r in range(self.world):
                off = r * chunk
                for i in sharded:
                    leaf = self.leaves[i]
                    buf[off:off + leaf.slice_numel].view(
                        leaf.slice_shape).copy_(leaf.region(self._grad(i),
                                                            r))
                    off += leaf.slice_numel
            out = torch.empty(chunk, dtype=torch.float32, device=buf.device)
            work.append(("reduce_scatter", sharded, out, _collective(
                "reduce_scatter_tensor", dist.reduce_scatter_tensor, out,
                buf, async_op=True)))
            for i in sharded:  # the full gradient is done with
                self.masters[i].grad = None
        self._pending[b] = work

    @torch.no_grad()
    def finish_grads(self):
        """After the group's backward: launch the buckets no hook did
        (all of them under plain ``--zero1``), wait for every reduction,
        and leave the summed gradients in place: the masters' ``.grad``
        (replicated leaves) and the slices' ``.grad``."""
        self._armed = False
        if self.fold:
            for i in range(len(self.masters)):
                self._fold(i)
        for b in range(len(self.buckets)):
            if b not in self._pending:
                self._launch(b)
        t0 = time.perf_counter()
        for b in sorted(self._pending):
            for kind, members, flat, handle in self._pending[b]:
                handle.wait()
                comm_stats["calls"] += 1
                off = 0
                for i in members:
                    if kind == "all_reduce":
                        n = self.masters[i].numel()
                        self.masters[i].grad.copy_(
                            flat[off:off + n].view_as(self.masters[i]))
                    else:
                        n = self.leaves[i].slice_numel
                        self.shards[i].grad = flat[off:off + n]
                    off += n
        comm_stats["seconds"] += time.perf_counter() - t0
        self._pending = {}

    def grads(self):
        """The reduced gradients the optimizer reads, in parameter
        order."""
        return [p.grad for p in self.optimizer_params()]

    def global_norm(self, grads):
        """``(norm, all_finite)`` of the global gradient from this rank's
        ``grads`` (:meth:`grads`): without ZeRO-1 every rank holds all of
        it; with it, the slices' squares are summed across ranks and each
        replicated leaf is counted once.  Device tensors, no host sync."""
        if not self.zero1:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            return norm, None
        sharded = [g for i, g in enumerate(grads) if i in self.shards]
        replicated = [g for i, g in enumerate(grads) if i not in self.shards]
        local = torch.stack(torch._foreach_norm(sharded))
        packed = torch.stack([
            (local * local).sum(),
            (~torch.isfinite(local)).sum().float()])
        self.all_reduce(packed)
        square = packed[0]
        finite = packed[1] == 0
        if replicated:
            rep = torch.stack(torch._foreach_norm(replicated))
            square = square + (rep * rep).sum()
            finite = finite & torch.isfinite(rep).all()
        return torch.sqrt(square), finite

    # -- the updated weights ---------------------------------------------

    @torch.no_grad()
    def _gather(self, sources, targets, dtype):
        """All-gather every rank's ``sources`` slices (flat, per sharded
        leaf, in ``dtype``) into the matching ``targets`` (full tensors),
        one collective a bucket."""
        pending = []
        for members in self.buckets:
            sharded = [i for i in members if i in self.shards]
            if not sharded:
                continue
            mine = torch.cat([sources[i].reshape(-1).to(dtype)
                              for i in sharded])
            out = torch.empty(self.world * mine.numel(), dtype=dtype,
                              device=mine.device)
            # 16-bit types ride as bytes, which every backend gathers
            wire = (lambda t: t.view(torch.uint8)) if dtype in (
                torch.bfloat16, torch.float16) else (lambda t: t)
            pending.append((sharded, mine.numel(), out, _collective(
                "all_gather_into_tensor", dist.all_gather_into_tensor,
                wire(out), wire(mine), async_op=True)))
        t0 = time.perf_counter()
        for sharded, chunk, out, handle in pending:
            handle.wait()
            comm_stats["calls"] += 1
            for r in range(self.world):
                off = r * chunk
                for i in sharded:
                    leaf = self.leaves[i]
                    leaf.region(targets[i], r).copy_(
                        out[off:off + leaf.slice_numel].view(
                            leaf.slice_shape))
                    off += leaf.slice_numel
        comm_stats["seconds"] += time.perf_counter() - t0

    def gather_params(self):
        """Plain ``--zero1``, after the update: every rank's updated
        slices into the replicated master params."""
        self._gather(self.shards, [p.data for p in self.masters],
                     torch.float32)

    def gather_full(self, tensors):
        """Full fp32 tensors of ``tensors`` (this rank's weights in
        parameter order, slices where sharded): the replicated ones as
        they are, the sharded ones gathered into new tensors."""
        full = [t if i not in self.shards
                else torch.empty_like(self.masters[i])
                for i, t in enumerate(tensors)]
        self._gather({i: tensors[i] for i in self.shards}, full,
                     torch.float32)
        return full

    @torch.no_grad()
    def gather_compute(self, generator=None, sources=None):
        """``--comms-overlap``, at the top of an update: the compute copy
        from the master slices (or ``sources``, the EMA's), rounded to
        nearest or, with ``generator`` (``--bf16-sr``), stochastically
        with one seed a leaf as the whole leaf would be, then gathered."""
        sources = self.optimizer_params() if sources is None else sources
        dtype = self.compute[0].dtype
        targets = [p.data for p in self.compute]
        if dtype == torch.float32:
            for i, t in enumerate(targets):
                if i not in self.shards and t is not sources[i]:
                    t.copy_(sources[i])
            self._gather(sources, targets, dtype)
            return
        local = {}
        outs = []
        for i, src in enumerate(sources):
            if i in self.shards:
                local[i] = torch.empty(src.shape, dtype=dtype,
                                       device=src.device)
                outs.append(local[i])
            else:
                outs.append(targets[i])
        if generator is not None and dtype == torch.bfloat16:
            fp32_to_bf16_sr_multi(
                list(sources), draw_seeds(generator, (len(sources),)), outs,
                [self.leaves[i].window() if i in self.shards else None
                 for i in range(len(sources))])
        else:
            torch._foreach_copy_(outs, list(sources))
        self._gather(local, targets, dtype)

    # -- host-side sums --------------------------------------------------

    def all_reduce(self, t, op=None):
        """Sum (or ``op``) ``t`` across ranks in place; returns it."""
        t0 = time.perf_counter()
        _collective("all_reduce", dist.all_reduce, t,
                    op=op or dist.ReduceOp.SUM)
        comm_stats["seconds"] += time.perf_counter() - t0
        comm_stats["calls"] += 1
        return t

    def sum_stats(self, sample_size, logs, loss_sum):
        """The sample size, logging outputs and scaled loss summed across
        ranks (one collective): the global batch's, as the JAX step gives
        them (the anomaly guard reads the loss, so every rank decides
        alike)."""
        keys = sorted(logs)
        packed = torch.stack(
            [sample_size.float().reshape(()), loss_sum.float().reshape(())]
            + [torch.as_tensor(logs[k], dtype=torch.float32,
                               device=sample_size.device).reshape(())
               for k in keys])
        self.all_reduce(packed)
        return (packed[0], {k: packed[2 + j] for j, k in enumerate(keys)},
                packed[1])

    def agree_slots(self, weights, device):
        """The micro-batch slots every rank has real data in: the min of
        the ranks' 0/1 ``weights`` (the JAX package's ragged-tail rule)."""
        t = torch.tensor(weights, dtype=torch.float32, device=device)
        self.all_reduce(t, op=dist.ReduceOp.MIN)
        return [float(w) for w in t.tolist()]

    def any(self, flag, device):
        """True on every rank if ``flag`` is on any rank."""
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        self.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def close(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []
