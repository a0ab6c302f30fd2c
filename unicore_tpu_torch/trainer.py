"""Training step of the port (counterpart of ``unicore_tpu/trainer.py``,
the part the BERT path runs).

One update: the micro-batches of ``--update-freq`` run forward and
backward one after another, their summed losses' gradients accumulate in
fp32, then the gradients are divided by the summed sample size (times the
loss scale, under ``--fp16``), their global norm is taken, they are
clipped to ``--clip-norm``, and the optimizer steps — unless a gradient
or the norm is not finite (an overflow), in which case the update is
skipped: params and optimizer state untouched, the update count
unchanged.
Without a loss scaler the step then raises ``FloatingPointError``, as the
reference does.

``--bf16`` keeps fp32 master parameters and runs forward and backward on
a bf16 copy of the model refreshed from them before each update (the
reference casts its fp32 params to bf16 for each micro-batch's forward;
round-to-nearest gives the same copy each time); the copy's gradients
fold into the fp32 master gradients.  ``--bf16-sr`` refreshes the copy
by stochastic rounding before every micro-batch instead, with fresh
seeds, as the reference's step does; ``--optim-bf16-moments`` stores
Adam's moments in bf16, re-quantized by stochastic rounding (every
other optimizer refuses it, as in the JAX trainer).

``--fp16`` (which takes precedence over ``--bf16``, as in the reference)
runs the compute copy in fp16 and scales each micro-batch's fp32 loss by
the dynamic loss scale (``optim/dynamic_loss_scaler.py``; its state two
device scalars, ``--fp16-init-scale``, ``--fp16-scale-window``).  An
overflow skips the update in place, as the JAX trainer's state bypass
does: the scaler halves (its floor ``--min-loss-scale / 2``), and the
step raises ``FloatingPointError`` only when the scale it used was
already at or below ``--min-loss-scale``.  Every update logs
``loss_scale``, the scale it used.

``--per-sample-clip-norm`` runs each micro-batch one example at a time,
as the JAX step's scan over examples does: each example's fp32 gradient
is scaled by ``min(1, clip / (|g| + 1e-6))``, its norm taken unscaled
(divided by the loss scale), and summed; the coefficient stays on the
device, so the loop adds no host sync, and under ``--bf16-sr`` every
example draws its own stochastic rounding of the compute copy.  The
division by the sample size and ``--clip-norm`` follow as without it.

``--ema-decay`` keeps an fp32 EMA of the master parameters, a copy of
them at construction (the JAX ``init_state``'s), updated after every
applied update by ``ops/ema.py`` bit for bit as the JAX step does, and
left as it is on a skipped one.  ``--validate-with-ema`` validates on
it; the master weights are untouched.

A non-finite step without a loss scaler runs the NaN detector
(``nan_detector.py``) on the clean state before it raises: the modules
whose outputs are non-finite on the step's first micro-batch, then the
non-finite leaves of the params and the optimizer's state, by their
flax paths.

``--step-timeout SEC`` arms a :class:`~unicore_tpu_torch.resilience.
watchdog.StepWatchdog` around the step's two host syncs, where a hung
kernel shows: the stats ``tolist`` (forward, backward and the gradient
norm) and, after the optimizer and the EMA, the sample size's read. A
sync that outlasts it dumps every thread's stack, names the checkpoint
writer's state, and exits 87.

``--log-memory N`` logs ``mem_gb``, the caching allocator's bytes in use
on the card, every N dispatches (nothing on the CPU, where the JAX
trainer's backend has no memory stats either); a step whose forward or
backward raises logs the allocator's stats at ERROR before the exception
goes on.  Validation batches hold ``--batch-size-valid`` examples.

Checkpoints (:meth:`Trainer.state_dict`, :meth:`Trainer.load_checkpoint`)
hold the JAX trainer's tree: ``"model"`` is ``{"step", "params",
"opt_state", "guard"}`` of numpy arrays in the flax layout (the model's
``flax_tree``), with ``"ema"`` beside them under ``--ema-decay``, so
either package resumes the other's file.  ``opt_state`` is the
optimizer's state in the JAX shape, each per-parameter entry a flax
tree; a file of another optimizer loads as the JAX trainer merges it
(``_load_opt_state``).  The port's
dropout generator is state the JAX trainer does not have; its bytes ride
``optimizer_history`` under ``"torch_generator_state"``, which the JAX
trainer ignores.  Under ``--fp16`` the tree has the JAX trainer's
``"scaler": {"scale", "growth_tracker"}`` slot, and ``dispatch_count``
counts every dispatched step, skipped ones included.

Data parallelism (a process group of more than one rank,
``distributed/``): each rank steps its shard of the batches
(``num_shards=world, shard_id=rank``), and one update is the JAX step's
on the ranks' batches side by side: the fp32 gradient, the sample size
and the logging outputs are summed across ranks before the division,
the norm, the clip and the overflow verdict, which every rank then
shares (:class:`~unicore_tpu_torch.distributed.data_parallel.
DataParallel`).  A micro-batch slot counts only where every rank has a
batch in it (the ragged epoch tail).  ``--zero1`` keeps each rank's
slices of the optimizer state only, ``--comms-overlap`` the master
params' and the EMA's too; their checkpoints are the JAX package's
sharded files.  Every rank draws the same numbers from the trainer's
generator (the kernels' seeds, with the rank's rows numbered after the
ranks before it, and every stochastic rounding), so the replicas stay
bit-equal; the masks drawn elementwise come from a generator of the
rank's own, reseeded each update from (seed, rank, update).  At world
size 1 the data-parallel flags change nothing.

Flags of the JAX trainer this slice does not port raise
``NotImplementedError`` naming their ``ROADMAP.md`` item
(:func:`refuse_unported`); none is ignored.
"""

import argparse
import copy
import logging
import os
import time

import numpy as np
import torch

from . import checkpoint_utils
from .device import resolve_device
from .distributed import utils as distributed_utils
from .distributed.data_parallel import DataParallel
from .logging import metrics
from .nan_detector import log_nonfinite_modules, log_nonfinite_state
from .ops import dropout as dropout_ops
from .ops import prng
from .ops.ema import ema_update_
from .optim import build_optimizer
from .optim.dynamic_loss_scaler import scaler_init, scaler_update
from .optim.fp16_optimizer import (default_scale_window, grads_finite,
                                   sync_master_to_model)
from .optim.lr_scheduler import build_lr_scheduler
from .resilience.watchdog import StepWatchdog

logger = logging.getLogger(__name__)

# (attribute, value meaning "off", flag, ROADMAP.md item)
UNPORTED = (
    ("fsdp_size", 1, "--fsdp-size", "A13"),
    ("fsdp", False, "--fsdp", "A13"),
    ("tensor_parallel_size", 1, "--tensor-parallel-size", "A13"),
    ("seq_parallel_size", 1, "--seq-parallel-size", "A13"),
    ("pack_sequences", False, "--pack-sequences", "A11"),
)


def refuse_unported(args):
    """Raise for a combination the JAX trainer refuses (``--zero1`` with
    fsdp or sequence parallelism, ``--comms-overlap`` without
    ``--zero1``), then ``NotImplementedError`` for the first flag that
    asks for a feature this slice has not ported."""
    if getattr(args, "zero1", False):
        if (getattr(args, "fsdp_size", 1) or 1) > 1:
            raise NotImplementedError(
                "--zero1 with --fsdp-size > 1 is redundant: the fsdp "
                "axis already shards the optimizer state (ZeRO); pick "
                "one scheme")
        if (getattr(args, "seq_parallel_size", 1) or 1) > 1:
            raise NotImplementedError(
                "--zero1 with --seq-parallel-size > 1 is not supported "
                "yet; the certified meshes are dp and dp x tp")
    if getattr(args, "comms_overlap", False) and not getattr(args, "zero1",
                                                             False):
        raise ValueError(
            "--comms-overlap requires --zero1 (it restructures the "
            "ZeRO-1 weight-update collectives; fsdp schedules its "
            "own gathers)")
    for attr, off, flag, item in UNPORTED:
        value = getattr(args, attr, off)
        if value is not None and value != off:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch trainer yet "
                f"(ROADMAP.md {item})")


def _examples(sample):
    """The examples of a collated batch, each a batch of one: every
    array leaf sliced along its first dim (the JAX step's scan over
    examples)."""
    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif hasattr(x, "shape"):
            yield x

    def take(x, i):
        if isinstance(x, dict):
            return {k: take(v, i) for k, v in x.items()}
        return x[i:i + 1] if hasattr(x, "shape") else x

    n = next(leaves(sample)).shape[0]
    return [take(sample, i) for i in range(n)]


def _to_device(sample, device):
    if isinstance(sample, dict):
        return {k: _to_device(v, device) for k, v in sample.items()}
    if hasattr(sample, "shape"):
        return torch.as_tensor(sample).to(device, non_blocking=True)
    return sample


class Trainer:
    def __init__(self, args, task, model, loss, device="cuda"):
        refuse_unported(args)
        self.args = args
        self.task = task
        self.loss = loss
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.compute_dtype = torch.float32
        if getattr(args, "fp16", False):
            self.compute_dtype = torch.float16
        elif getattr(args, "bf16", False):
            self.compute_dtype = torch.bfloat16
        self.use_scaler = self.compute_dtype == torch.float16
        if self.compute_dtype == torch.float32:
            self.compute_model = self.model
        else:
            self.compute_model = copy.deepcopy(self.model).to(
                self.compute_dtype)
        self.bf16_sr = bool(getattr(args, "bf16_sr", False))
        if self.bf16_sr and self.compute_dtype != torch.bfloat16:
            raise ValueError(
                "--bf16-sr requires --bf16 (stochastic rounding applies to "
                "the fp32->bf16 master->model cast only)")
        self.clip_norm = float(getattr(args, "clip_norm", 0.0) or 0.0)
        self.per_sample_clip_norm = float(
            getattr(args, "per_sample_clip_norm", 0.0) or 0.0)
        if (self.per_sample_clip_norm > 0
                and not task.logging_outputs_can_be_summed(loss, True)):
            raise ValueError(
                "--per-sample-clip-norm requires summable logging outputs "
                "(per-example logs are accumulated inside the step)")
        self.seed = int(getattr(args, "seed", 1))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        # data parallelism: the process group's world, and its
        # collectives (--zero1 and --comms-overlap act only above one
        # rank, as the JAX trainer's on a data axis of one device)
        self.data_parallel_world_size = \
            distributed_utils.get_data_parallel_world_size()
        self.data_parallel_rank = distributed_utils.get_data_parallel_rank()
        self.is_data_parallel_master = self.data_parallel_rank == 0
        self.dp = None
        if self.data_parallel_world_size > 1:
            self.dp = DataParallel(
                self.model, self.compute_model,
                zero1=getattr(args, "zero1", False),
                overlap=getattr(args, "comms_overlap", False),
                bucket_bytes=int(float(getattr(args, "comms_bucket_mb", 4.0)
                                       or 4.0) * (1 << 20)))
            prng.set_row_shard(self.data_parallel_rank)
            self.rank_generator = torch.Generator(device=self.device)
            dropout_ops.set_rank_generator(self.generator,
                                           self.rank_generator)
            # the shard token's run nonce, agreed once here
            import uuid

            self._run_nonce = distributed_utils.all_gather_objects(
                uuid.uuid4().hex)[0]
        self._shard_entries = {}
        self._reader = None  # the loaded file's shard pieces
        self.ema_decay = float(getattr(args, "ema_decay", -1) or -1)
        # the JAX init_state's EMA: a copy of the params as they are now
        self.ema = ([p.detach().clone(memory_format=torch.contiguous_format)
                     for p in self._master_params()]
                    if self.ema_decay > 0 else None)
        self.validate_with_ema = bool(getattr(args, "validate_with_ema",
                                              False))
        update_freq = getattr(args, "update_freq", 1)
        if isinstance(update_freq, (list, tuple)):
            update_freq = update_freq[0]
        self.scale_window = (getattr(args, "fp16_scale_window", None)
                             or default_scale_window(
                                 self.data_parallel_world_size, update_freq))
        self.min_loss_scale = float(getattr(args, "min_loss_scale", 1e-4))
        self.scaler = (scaler_init(float(getattr(args, "fp16_init_scale",
                                                 2 ** 7)),
                                   device=self.device)
                       if self.use_scaler else None)
        self.optimizer = self._build_optimizer()
        if (getattr(args, "optim_bf16_moments", False)
                and getattr(self.optimizer, "moments_dtype", torch.float32)
                == torch.float32):
            # a flag the optimizer ignores must not pass as a silent no-op
            raise NotImplementedError(
                "--optim-bf16-moments is implemented by the adam optimizer "
                f"only; --optimizer {getattr(args, 'optimizer', '?')} keeps "
                "full-precision state")
        self.total_train_steps = getattr(args, "max_update", 0) or None
        self.lr_scheduler = build_lr_scheduler(args, self.optimizer,
                                               self.total_train_steps)
        self.lr_scheduler.step_update(0)
        self._num_updates = 0
        # steps dispatched, skipped ones included (the JAX trainer's
        # dropout-stream counter, which checkpoints carry)
        self._dispatch_count = 0
        self._start_time = time.time()
        self._previous_training_time = 0.0
        # --step-timeout: armed around the step's host syncs only, so
        # a kernel's build at its first launch (minutes of nvcc on a cold
        # run) never reads as a hung step
        self._ckpt_writer = None
        self._watchdog = StepWatchdog(
            float(getattr(args, "step_timeout", 0) or 0),
            context=self._watchdog_context)
        metrics.log_start_time("wall", priority=790, round=0)

    def _build_optimizer(self):
        """The optimizer over the master params, or under ZeRO-1 over this
        rank's slices (whose stochastic roundings draw their leaves'
        bits)."""
        if self.dp is None:
            return build_optimizer(self.args, list(self.model.parameters()))
        optimizer = build_optimizer(self.args, self.dp.optimizer_params())
        optimizer.sr_windows = self.dp.sr_windows()
        return optimizer

    def attach_checkpoint_writer(self, writer):
        """Wire the checkpoint manager's background writer in: the
        watchdog's timeout dump then names the writer's state (a slow
        background write must not read as a hung device step)."""
        self._ckpt_writer = writer

    def _watchdog_context(self):
        if self._ckpt_writer is not None:
            return str(self._ckpt_writer.status())
        return "no context sources attached"

    # -- one update --------------------------------------------------------

    def _master_params(self):
        """The fp32 master parameters the checkpoint and the EMA carry,
        in parameter order (this rank's slices of the sharded leaves
        under ``--comms-overlap``)."""
        if self.dp is not None and self.dp.overlap:
            return self.dp.master_tensors()
        return [p for p in self.model.parameters() if p.requires_grad]

    def _full_weights(self, tensors):
        """Weights in parameter order that this rank may hold as slices
        (``--comms-overlap``'s master params and EMA), whole: the sharded
        ones all-gathered (a collective: every rank calls it)."""
        if self.dp is None or not self.dp.overlap:
            return list(tensors)
        return self.dp.gather_full(list(tensors))

    def _sync_compute_params(self, stochastic=False):
        """Refresh the compute copy from the master params: round to
        nearest, or stochastically with fresh seeds (under
        ``--comms-overlap``, from the slices, then gathered)."""
        if self.dp is not None and self.dp.overlap:
            self.dp.gather_compute(self.generator if stochastic else None)
            return
        if self.compute_model is self.model:
            return
        sync_master_to_model(list(self.model.parameters()),
                             list(self.compute_model.parameters()),
                             self.generator if stochastic else None)

    def _fold_compute_grads(self):
        """Add the compute copy's gradients into the fp32 master grads."""
        if self.compute_model is self.model:
            return
        with torch.no_grad():
            for m, c in zip(self.model.parameters(),
                            self.compute_model.parameters()):
                if c.grad is None:
                    continue
                if m.grad is None:
                    m.grad = c.grad.float()
                else:
                    m.grad += c.grad
                c.grad = None

    @metrics.aggregate("train")
    def train_step(self, samples):
        """One update over the micro-batches ``samples`` (a list of
        collated numpy batches).  Returns the summed logging output as a
        one-element list."""
        samples = self._agreed_samples(samples)
        if not samples:
            # the epoch's ragged tail left no slot with data on every
            # rank: nothing to step on (the JAX step would apply a zero
            # gradient, then divide its logs by a zero sample size)
            logger.info("no micro-batch slot has data on every rank; no "
                        "update")
            return []
        self.compute_model.train()
        self._dispatch_count += 1
        if self.dp is not None:
            # this rank's own elementwise dropout masks: a stream of its
            # own a dispatch, from (seed, rank, dispatch count) alone
            self.rank_generator.manual_seed(int(np.random.SeedSequence(
                [self.seed & 0xFFFFFFFF, self.data_parallel_rank,
                 self._dispatch_count]).generate_state(1, np.uint64)[0]
                >> np.uint64(1)))
        self.optimizer.set_lr(self.lr_scheduler.step_update(self._num_updates))
        scale = self.scaler["scale"] if self.use_scaler else None
        if not self.bf16_sr:
            self._sync_compute_params()
        try:
            sample_size, logs = self._accumulate_grads(samples, scale)
        except Exception:
            # the JAX trainer logs the device's memory when a step fails
            self.log_memory_stats(level=logging.ERROR)
            raise
        if self.dp is not None and self.dp.zero1:
            grads = self.dp.grads()  # this rank's slices
        else:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
        # unscale and normalize in one divide, as the reference
        denom = torch.clamp(sample_size, min=1.0)
        if scale is not None:
            denom = denom * scale
        torch._foreach_div_(grads, denom)
        finite = None
        if self.dp is not None:
            grad_norm, finite = self.dp.global_norm(grads)
        else:
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm > 0:
            # a tensor over a tensor: ``number / tensor`` multiplies by a
            # reciprocal, rounding twice where the reference divides once
            clip = grad_norm.new_full((), self.clip_norm)
            torch._foreach_mul_(
                grads, torch.clamp(clip / (grad_norm + 1e-6), max=1.0))
        if finite is None:
            finite = grads_finite(grads)
        overflow = ~(finite & torch.isfinite(grad_norm))
        stats = [grad_norm.float(), overflow.float()]
        if self.use_scaler:
            self.scaler = scaler_update(self.scaler, overflow,
                                        self.scale_window,
                                        min_scale=self.min_loss_scale / 2.0)
            stats.append(scale)  # the scale this step used
        stats = torch.stack(stats)
        # the step's first host sync (the JAX trainer's dispatch and its
        # stats sync in one), armed
        with self._watchdog.armed("train_step/stats-sync"):
            grad_norm, overflow, *used = stats.tolist()
        scale = used[0] if used else None
        self._log_memory_gauge()
        logging_outputs = [logs]
        if overflow:
            metrics.log_scalar("n_skipped", 1, priority=600, round=0)
            if not self.use_scaler:
                self._detect_nonfinite(samples[0])
                raise FloatingPointError(
                    f"Non-finite gradients detected (grad norm {grad_norm})"
                    " and no fp16 loss scaler to absorb them; the update "
                    "was skipped; see NanDetector log above.")
            if scale <= self.min_loss_scale:
                raise FloatingPointError(
                    f"Minimum loss scale reached ({scale}). Your loss is "
                    "probably exploding.")
            logger.info("non-finite gradients detected at loss scale %s, "
                        "skipping update", scale)
        else:
            if getattr(self.optimizer, "wants_update_rng", False):
                self.optimizer.step(generator=self.generator)
            else:
                self.optimizer.step()
            if self.dp is not None and self.dp.zero1 and not self.dp.overlap:
                self.dp.gather_params()
            if self.ema is not None:
                ema_update_(self.ema, self._master_params(), self.ema_decay)
            # the update's sync: it waits on the optimizer's and the EMA's
            # kernels (the JAX step's update sits inside its armed stats
            # sync), so a hung update exits 87 here, not at some later
            # unarmed sync
            with self._watchdog.armed("train_step/update-sync"):
                sample_size = float(sample_size)
            self.set_num_updates(self._num_updates + 1)
            self._reduce_and_log_stats(logging_outputs, sample_size,
                                       grad_norm)
        if self.use_scaler:
            metrics.log_scalar("loss_scale", scale, priority=700, round=4)
        return logging_outputs

    def _agreed_samples(self, samples):
        """The micro-batches to run: all of them on one rank; under data
        parallelism only the slots where every rank has a batch (the
        JAX trainer's ragged-tail rule: a rank's shard ends in empty
        batches where the epoch's batches ran out), in one collective."""
        if self.dp is None:
            return samples
        mine = [0.0 if s is None or len(s) == 0 else 1.0 for s in samples]
        agreed = self.dp.agree_slots(mine, self.device)
        dropped = int(sum(mine) - sum(agreed))
        if dropped:
            logger.info("dropping %d ragged-tail micro-batch(es) to keep "
                        "hosts in lockstep", dropped)
        return [s for s, w in zip(samples, agreed) if w > 0]

    def _accumulate_grads(self, samples, scale):
        """Forward and backward over the micro-batches ``samples`` (one
        example at a time under ``--per-sample-clip-norm``); the summed
        fp32 gradients land in the master params' ``.grad`` (under data
        parallelism summed across ranks: the masters', or this rank's
        slices' under ``--zero1``).  Returns the summed sample size (a
        device scalar) and logging output (summed across ranks).  No host
        sync on one rank."""
        for p in self.model.parameters():
            p.grad = None
        if self.dp is not None:
            for p in self.dp.optimizer_params():
                p.grad = None
        sample_size = torch.zeros((), device=self.device)
        logs = {}
        clipped = None
        runs = [batch for sample in samples
                for batch in (_examples(sample)
                              if self.per_sample_clip_norm > 0
                              else [sample])]
        for i, batch in enumerate(runs):
            # the group's last backward launches the reductions from its
            # gradient hooks (after the last example's clip, under
            # --per-sample-clip-norm, which needs its whole gradient)
            last = (self.dp is not None and i == len(runs) - 1
                    and self.per_sample_clip_norm <= 0)
            ss, log = self._forward_backward(batch, scale, last)
            if self.per_sample_clip_norm > 0:
                clipped = self._add_clipped(clipped, scale)
            sample_size = sample_size + ss
            for k, v in log.items():
                logs[k] = logs.get(k, 0.0) + v
        if clipped is not None:
            for p, g in zip(self.model.parameters(), clipped):
                p.grad = g
        if self.dp is not None:
            self.dp.finish_grads()
            sample_size, logs = self.dp.sum_stats(sample_size, logs)
        return sample_size, logs

    def _forward_backward(self, sample, scale, last=False):
        """Forward and backward of one batch on the compute copy (after
        its stochastic rounding under ``--bf16-sr``); the fp32 gradients
        add into the master params' ``.grad``.  ``last``: the group's
        last backward, whose hooks start the reductions across ranks.
        Returns the sample size and the logging output."""
        if self.bf16_sr:
            self._sync_compute_params(stochastic=True)
        sample = _to_device(sample, self.device)
        loss, ss, log = self.loss(self.compute_model, sample,
                                  generator=self.generator)
        loss = loss.float()
        if scale is not None:
            loss = loss * scale
        if last:
            self.dp.arm()
        loss.backward()
        self._fold_compute_grads()
        return ss, log

    @torch.no_grad()
    def _add_clipped(self, clipped, scale):
        """Take the gradients of one example off the master params, scale
        them by ``min(1, clip / (|g| + 1e-6))`` (the norm unscaled) and add
        them to ``clipped`` (a list in parameter order, None where no
        example gave a gradient yet); returns it.  No host sync: the
        coefficient stays on the device, and an inf gradient turns NaN
        (inf * 0), which the overflow check then sees."""
        params = list(self.model.parameters())
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        live = [g for g in grads if g is not None]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(live)))
        if scale is not None:
            norm = norm / scale
        # a tensor over a tensor, as the global clip in ``train_step``
        clip = norm.new_full((), self.per_sample_clip_norm)
        torch._foreach_mul_(live, torch.clamp(clip / (norm + 1e-6), max=1.0))
        if clipped is None:
            return grads
        both = [(a, g) for a, g in zip(clipped, grads)
                if a is not None and g is not None]
        if both:
            torch._foreach_add_([a for a, _ in both], [g for _, g in both])
        return [g if a is None else a for a, g in zip(clipped, grads)]

    def _device_memory_stats(self):
        """The caching allocator's stats of the card; None on the CPU."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.memory_stats(self.device)

    def _log_memory_gauge(self):
        """``mem_gb``, the allocator's bytes in use, every ``--log-memory``
        dispatches (on the card only, as the JAX trainer logs it only
        where its backend has memory stats)."""
        every = int(getattr(self.args, "log_memory", 0) or 0)
        if every > 0 and self._dispatch_count % every == 0:
            ms = self._device_memory_stats()
            if ms is not None:
                metrics.log_scalar(
                    "mem_gb", ms.get("allocated_bytes.all.current", 0) / 1e9,
                    priority=710, round=2, weight=0)

    def log_memory_stats(self, level=logging.INFO):
        """Log the card's allocator stats (the bytes in GB), or that there
        are none on this device."""
        ms = self._device_memory_stats()
        if not ms:
            logger.log(level, "device memory stats unavailable")
            return
        logger.log(level, "device memory: %s", ", ".join(
            f"{k}={v / 1e9:.2f}GB" if "bytes" in k else f"{k}={v}"
            for k, v in sorted(ms.items()) if ".all." in k or "." not in k))

    @torch.no_grad()
    def _detect_nonfinite(self, sample):
        """The NaN detector on the clean state (the failing update was
        not applied): the modules with non-finite outputs on ``sample``,
        then the non-finite leaves of params and optimizer state.  A failure
        of the detector is logged and never masks the step's error."""
        state = None
        if self.dp is not None:
            # the collectives outside the guard, on every rank alike
            state = self.detector_state()
            if self.dp.overlap:
                self.dp.gather_params()  # the fp32 module runs the re-run
        try:
            log_nonfinite_modules(self.model, _to_device(sample, self.device))
            log_nonfinite_state(state or self.detector_state(),
                                header="train state")
        except Exception as e:  # the detector must never mask the abort
            logger.warning("NanDetector re-run failed: %s", e)

    def detector_state(self):
        """``{"params", "opt_state"}`` as the JAX trainer hands them to its
        state detector: flax trees of numpy copies (whole leaves, also
        of what this rank holds as slices)."""
        return {"params": self._flax(self._full_weights(
                    self._master_params())),
                "opt_state": self._flax_opt_state()}

    @torch.no_grad()
    def valid_step(self, sample):
        """Loss of one validation batch, dropout off; on the EMA weights
        (cast to the compute type) under ``--validate-with-ema``.  Under
        data parallelism an empty batch (a rank's shard padding) runs the
        step's collectives and returns no output."""
        self.compute_model.eval()
        use_ema = self.validate_with_ema and self.ema is not None
        if not use_ema:
            self._sync_compute_params()
        ema = self._full_weights(self.ema) if use_ema else None
        if self.dp is not None and (sample is None or len(sample) == 0):
            return []
        sample = _to_device(sample, self.device)
        if not use_ema:
            _, _, log = self.loss(self.compute_model, sample)
            return [log]
        if self.compute_model is not self.model:
            sync_master_to_model(ema, [
                p for p in self.compute_model.parameters() if p.requires_grad])
            _, _, log = self.loss(self.compute_model, sample)
            return [log]
        # fp32: the model is its own compute copy; swap the EMA in and
        # the master weights back, untouched
        params = [p for p in self.model.parameters() if p.requires_grad]
        saved = [p.data for p in params]
        try:
            for p, e in zip(params, ema):
                p.data = e
            _, _, log = self.loss(self.compute_model, sample)
        finally:
            for p, d in zip(params, saved):
                p.data = d
        return [log]

    # -- bookkeeping (the reference's names) -------------------------------

    def _reduce_and_log_stats(self, logging_outputs, sample_size, grad_norm):
        metrics.log_speed("ups", 1.0, priority=100, round=2)
        metrics.log_scalar("gnorm", grad_norm, priority=400, round=3)
        if self.clip_norm > 0:
            metrics.log_scalar(
                "clip", 100.0 if grad_norm > self.clip_norm else 0.0,
                priority=500, round=1)
        with metrics.aggregate() as agg:
            self.task.reduce_metrics(logging_outputs, self.loss)
        logging_output = agg.get_smoothed_values()
        logging_output["sample_size"] = sample_size
        for k, v in logging_output.items():
            metrics.log_scalar(k, v)

    def begin_epoch(self, epoch):
        logger.info("begin training epoch {}".format(epoch))
        self.lr_scheduler.step_begin_epoch(epoch)
        self.lr_step_update()
        self.task.begin_epoch(epoch, self.model)

    def lr_step_update(self):
        new_lr = self.lr_scheduler.step_update(self._num_updates)
        metrics.log_scalar("lr", new_lr, weight=0, priority=300)
        return new_lr

    def get_num_updates(self):
        return self._num_updates

    def set_num_updates(self, num_updates):
        self._num_updates = num_updates
        self.lr_step_update()
        metrics.log_scalar("num_updates", num_updates, weight=0,
                           priority=200)

    def get_lr(self):
        return self.optimizer.get_lr()

    def lr_step(self, epoch, val_loss=None):
        self.lr_scheduler.step(epoch, val_loss)
        return self.lr_step_update()

    def init_total_train_steps(self, epoch_itr):
        """Total updates of the run, for schedules that read it."""
        if getattr(self.args, "max_update", 0) > 0:
            total = self.args.max_update
        else:
            max_epoch = getattr(self.args, "max_epoch", 0) or 1
            total = len(epoch_itr) // self.args.update_freq[0] * max_epoch
        self.total_train_steps = self.lr_scheduler.total_train_steps = total

    def cumulative_training_time(self):
        return time.time() - self._start_time + self._previous_training_time

    def get_train_iterator(self, epoch, combine=True, load_dataset=True,
                           data_selector=None, shard_batch_itr=True,
                           disable_iterator_cache=False):
        """The train split's epoch iterator (the reference's signature),
        loading batches with ``--num-workers`` workers of
        ``--worker-impl`` ahead of the loop by ``--data-buffer-size``;
        this rank's shard of the batches (all of them with
        ``shard_batch_itr=False``)."""
        if load_dataset:
            self.task.load_dataset(self.args.train_subset, epoch=epoch,
                                   combine=combine,
                                   data_selector=data_selector)
        return self.task.get_batch_iterator(
            self.task.dataset(self.args.train_subset),
            batch_size=self.args.batch_size,
            ignore_invalid_inputs=True,
            required_batch_size_multiple=self.args.required_batch_size_multiple,
            seed=self.seed,
            num_shards=(self.data_parallel_world_size if shard_batch_itr
                        else 1),
            shard_id=self.data_parallel_rank if shard_batch_itr else 0,
            num_workers=self.args.num_workers, epoch=epoch,
            data_buffer_size=self.args.data_buffer_size,
            disable_iterator_cache=disable_iterator_cache)

    def gather_logging_outputs(self, logging_outputs):
        """Every rank's validation outputs, summed per rank and listed in
        rank order (``--all-gather-list-size`` bounds each rank's);
        unchanged on one rank."""
        if self.dp is None:
            return logging_outputs
        summed = {}
        for log in logging_outputs:
            for k, v in log.items():
                summed[k] = summed.get(k, 0.0) + float(v)
        return distributed_utils.all_gather_objects(
            summed, int(getattr(self.args, "all_gather_list_size", 16384)))

    def agree(self, flag):
        """A host decision (stop, preempted) taken on any rank, taken on
        every rank."""
        if self.dp is None:
            return flag
        return self.dp.any(flag, self.device)

    def get_valid_iterator(self, subset, disable_iterator_cache=False):
        return self.task.get_batch_iterator(
            self.task.dataset(subset),
            batch_size=getattr(self.args, "batch_size_valid", None)
            or self.args.batch_size,
            ignore_invalid_inputs=True,
            required_batch_size_multiple=self.args.required_batch_size_multiple,
            seed=self.seed, num_shards=self.data_parallel_world_size,
            shard_id=self.data_parallel_rank,
            num_workers=self.args.num_workers,
            data_buffer_size=self.args.data_buffer_size,
            disable_iterator_cache=disable_iterator_cache)

    # -- checkpoint state (the JAX trainer's tree) -------------------------

    def _param_names(self):
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _flax(self, leaves):
        """Tensors in parameter order -> the flax tree of numpy copies."""
        return self.model.flax_tree(dict(zip(self._param_names(), leaves)))

    def _flax_opt_state(self):
        """The optimizer's state as the JAX trainer's ``opt_state`` tree:
        ``"step"`` as it is, and every per-parameter entry (Adam's
        moments, SGD's momentum buffer, Adagrad's sum, ...) mapped onto
        the params' flax tree, whatever its key; whole leaves, gathered
        where this rank holds slices (a collective under ``--zero1``)."""
        state = self.optimizer.state_dict()
        if self.dp is not None and self.dp.zero1:
            state = {key: value if key == "step"
                     else self.dp.gather_full(value)
                     for key, value in state.items()}
        return {key: value if key == "step" else self._flax(value)
                for key, value in state.items()}

    def _tree(self, tensors, prefix, sliced):
        """Tensors in parameter order -> the checkpoint's flax tree at
        ``prefix`` (``"params"``, ``"ema"``, ``"opt_state/exp_avg"``...).
        Under data parallelism, with ``sliced`` (this rank holds the
        sharded leaves as slices) a sharded leaf is a
        :class:`~unicore_tpu_torch.checkpoint_utils.ShardedLeaf` marker
        and its piece goes to this rank's shard entries; the whole leaves
        are copied on rank 0 only (None elsewhere: only rank 0 writes the
        main file)."""
        if self.dp is None:
            return self._flax(tensors)
        tree = {}
        for leaf, t in zip(self.dp.leaves, tensors):
            if sliced and leaf.sharded:
                value = checkpoint_utils.ShardedLeaf(
                    leaf.flax_shape, "bfloat16" if t.dtype == torch.bfloat16
                    else "float32")
                self._shard_entries["/".join((prefix,) + leaf.path)] = [
                    (leaf.flax_index(), _host(leaf.to_flax(t)))]
            elif self.is_data_parallel_master:
                value = _host(leaf.to_flax(t))
            else:
                value = None
            node = tree
            for key in leaf.path[:-1]:
                node = node.setdefault(key, {})
            node[leaf.path[-1]] = value
        return tree

    def _leaves(self, tree, prefix="params", sliced=False):
        """A flax tree of the model's layout (at ``prefix`` in the file)
        -> tensors in parameter order: whole, or with ``sliced`` this
        rank's slice of each sharded leaf.  A marker of a sharded file
        reads its piece from the shard files (this rank's own first), or
        assembles the whole leaf."""
        if self.dp is None:
            if self._reader is not None:
                tree = self._reader.assembled(tree, prefix)
            named = self.model.named_from_flax(tree)
            return [named[n] for n in self._param_names()]
        return [self._dp_leaf(leaf, tree, prefix, sliced)
                for leaf in self.dp.leaves]

    def _dp_leaf(self, leaf, tree, prefix, sliced):
        value = tree
        for key in leaf.path:
            value = value[key]
        key = "/".join((prefix,) + leaf.path)
        marker = isinstance(value, checkpoint_utils.ShardedLeaf)
        if sliced and leaf.sharded:
            if marker:
                piece = self._reader.piece(key, leaf.flax_index())
                if piece is not None:
                    return leaf.from_flax(np.asarray(piece, np.float32),
                                          piece=True)
            whole = (self._reader.full(key, value) if marker else value)
            return leaf.take(leaf.from_flax(np.asarray(whole, np.float32),
                                            piece=False))
        if marker:
            value = self._reader.full(key, value)
        return leaf.from_flax(np.asarray(value, np.float32), piece=False)

    @torch.no_grad()
    def _load_params(self, tree, prefix):
        """The file's params (or EMA, ``prefix``) into the master weights:
        the module's params, and under ZeRO-1 this rank's slices (the
        masters themselves under ``--comms-overlap``)."""
        if self.dp is None:
            self.model.load_flax_params(
                tree if self._reader is None
                else self._reader.assembled(tree, prefix))
            return
        dp = self.dp
        for leaf, t in zip(dp.leaves, self._leaves(tree, prefix,
                                                   dp.overlap)):
            if dp.overlap and leaf.sharded:
                dp.shards[leaf.index].copy_(t)
            else:
                dp.masters[leaf.index].copy_(t)
                if leaf.index in dp.shards:
                    dp.shards[leaf.index].copy_(
                        leaf.take(dp.masters[leaf.index]))

    def shard_entries(self):
        """This rank's pieces of the sharded leaves of the last collected
        state (``{leaf path: [(index, array)]}``; empty without ZeRO-1)."""
        return self._shard_entries

    def _load_opt_state(self, saved):
        """The file's ``opt_state`` into the optimizer, as the JAX
        trainer's merge takes it into its fresh state: an entry both have
        is restored, an entry only the optimizer has keeps its fresh
        value, an entry only the file has is dropped, each logged; a
        leaf of another shape raises."""
        fresh = self.optimizer.state_dict()
        for key in saved:
            if key not in fresh:
                logger.warning("checkpoint: dropping /opt_state/%s (not in "
                               "model)", key)
        for key in fresh:
            if key not in saved:
                logger.warning("checkpoint: /opt_state/%s missing; keeping "
                               "fresh init", key)
        self.optimizer.load_state_dict({
            key: value if key == "step" else self._leaves(
                value, f"opt_state/{key}", self.dp is not None
                and self.dp.zero1)
            for key, value in saved.items() if key in fresh})

    def state_dict(self):
        """The checkpoint: numpy arrays and plain values only, so the JAX
        package reads it without torch.  Under data parallelism the
        sharded leaves are markers and :meth:`shard_entries` holds this
        rank's pieces of them; the tree carries the save's
        ``shard_token``."""
        self._shard_entries = {}
        overlap = self.dp is not None and self.dp.overlap
        model = {
            "step": np.asarray(self._num_updates, np.int32),
            "params": self._tree(self._master_params(), "params", overlap),
            # the JAX trainer's anomaly-guard scalars (its guard_init); the
            # port has no guard, and zeros load there without a warning
            "guard": {"loss_ema": np.zeros((), np.float32),
                      "loss_emsq": np.zeros((), np.float32),
                      **{k: np.zeros((), np.int32)
                         for k in ("count", "streak", "skips", "spikes")}},
        }
        if self.ema is not None:
            model["ema"] = self._tree(self.ema, "ema", overlap)
        if self.use_scaler:
            model["scaler"] = {
                "scale": self.scaler["scale"].cpu().numpy(),
                "growth_tracker": self.scaler["growth_tracker"].cpu().numpy()}
        if not getattr(self.args, "no_save_optimizer_state", False):
            # "step" as it is, and every per-parameter entry (Adam's
            # moments, SGD's momentum buffer, ...) on the params' tree
            model["opt_state"] = {
                key: value if key == "step" else self._tree(
                    value, f"opt_state/{key}",
                    self.dp is not None and self.dp.zero1)
                for key, value in self.optimizer.state_dict().items()}
        state = {
            "args": _plain_args(self.args),
            "model": model,
            "optimizer_history": [{
                "loss_name": self.loss.__class__.__name__,
                "optimizer_name": self.optimizer.__class__.__name__,
                "lr_scheduler_state": self.lr_scheduler.state_dict(),
                "num_updates": self._num_updates,
                # the JAX trainer's dropout-stream counter: every
                # dispatched step, skipped ones included
                "dispatch_count": self._dispatch_count,
                "torch_generator_state":
                    self.generator.get_state().numpy().copy(),
            }],
            "task_state": dict(self.task.state_dict()),
            "extra_state": {
                "metrics": metrics.state_dict(),
                "previous_training_time": self.cumulative_training_time(),
            },
        }
        if self.dp is not None:
            # binds the .shard<N> files to this save (the JAX trainer's
            # token: the run's nonce, agreed by the ranks, and the update)
            state["shard_token"] = f"{self._run_nonce}:{self._num_updates}"
        return state

    def collect_checkpoint_state(self, extra_state):
        """Everything a checkpoint write needs, copied to the host: the
        synchronous part of a save (the manager serializes it)."""
        state_dict = self.state_dict()
        state_dict["extra_state"].update(extra_state)
        return state_dict

    def save_checkpoint(self, filename, extra_state):
        """Direct synchronous save: the main file on rank 0, each rank's
        shard file where it holds sharded pieces."""
        logger.info("Saving checkpoint to %s", filename)
        state = self.collect_checkpoint_state(extra_state)
        if self.dp is None:
            checkpoint_utils.atomic_save(state, filename)
        else:
            checkpoint_utils.write_checkpoint(
                state, self._shard_entries, filename,
                self.is_data_parallel_master, self.data_parallel_rank)
        logger.info("Finished saving checkpoint to %s", filename)

    def load_checkpoint(self, filename, reset_optimizer=False,
                        reset_lr_scheduler=False, optimizer_overrides=None,
                        reset_meters=False, load_from_ema=None):
        """Load a checkpoint of either package; returns its
        ``extra_state`` (None when ``filename`` does not exist).
        ``load_from_ema`` (default ``--load-from-ema``) starts from the
        file's EMA weights, unless ``reset_optimizer`` restores the params
        alone."""
        if not os.path.exists(filename):
            logger.info("No existing checkpoint found %s", filename)
            return None
        state = checkpoint_utils.load_checkpoint_to_cpu(filename)
        last = state.get("optimizer_history", [{}])[-1]
        # the pieces of a sharded file's leaves: this rank's .shard file
        # first, every one of the save where a piece is not there
        self._reader = (checkpoint_utils.ShardReader(
            filename, state.get("shard_token"), self.data_parallel_rank)
            if checkpoint_utils.has_markers(state.get("model")) else None)
        if optimizer_overrides:
            for k, v in optimizer_overrides.items():
                logger.info("overriding optimizer arg %s=%r", k, v)
                setattr(self.args, k, v)
            self.optimizer = self._build_optimizer()
            self.lr_scheduler = build_lr_scheduler(
                self.args, self.optimizer, self.total_train_steps)
        if load_from_ema is None:
            load_from_ema = bool(getattr(self.args, "load_from_ema", False))
        model_state = state.get("model")
        if model_state is not None:
            params, prefix = model_state["params"], "params"
            if (load_from_ema and not reset_optimizer
                    and model_state.get("ema") is not None):
                logger.info("loading EMA weights as model params")
                params, prefix = model_state["ema"], "ema"
            self._load_params(params, prefix)
            self._load_ema(model_state.get("ema"), reset_optimizer, filename)
            if reset_optimizer:
                logger.info("--reset-optimizer: restoring params only")
            elif "opt_state" in model_state:
                self._load_opt_state(model_state["opt_state"])
            else:
                logger.warning("checkpoint: %s holds no optimizer state; "
                               "keeping fresh init", filename)
            self._load_scaler(model_state.get("scaler"), reset_optimizer,
                              filename)
        if not reset_lr_scheduler:
            self.lr_scheduler.load_state_dict(
                last.get("lr_scheduler_state", {}))
        if not reset_optimizer:
            step = (0 if model_state is None
                    else int(model_state.get("step", 0)))
            self.set_num_updates(last.get("num_updates", step))
            dispatched = last.get("dispatch_count")
            self._dispatch_count = (self._num_updates if dispatched is None
                                    else int(dispatched))
            self._load_generator(last.get("torch_generator_state"))
        self.task.load_state_dict(state.get("task_state", {}))
        extra_state = state.get("extra_state", {}) or {}
        if not reset_meters and "metrics" in extra_state:
            metrics.load_state_dict(extra_state["metrics"])
        self._previous_training_time = extra_state.get(
            "previous_training_time", 0.0)
        logger.info("Loaded checkpoint %s (epoch %s @ %d updates)", filename,
                    extra_state.get("train_iterator", {}).get("epoch", 0),
                    self.get_num_updates())
        return extra_state

    @torch.no_grad()
    def _load_ema(self, saved, reset_optimizer, filename):
        """The EMA slot, as the JAX trainer merges it: restored under
        ``--ema-decay``; with ``--reset-optimizer``, or from a file that
        has none, the EMA made at construction stays (a copy of the
        params before the load: the JAX trainer's fresh init too); dropped
        without ``--ema-decay``."""
        if self.ema is None:
            if saved is not None:
                logger.warning("checkpoint: dropping %s's EMA (not training "
                               "under --ema-decay)", filename)
            return
        if reset_optimizer:
            return
        if saved is None:
            logger.warning("checkpoint: %s holds no EMA; keeping the fresh "
                           "one", filename)
            return
        for e, s in zip(self.ema, self._leaves(
                saved, "ema", self.dp is not None and self.dp.overlap)):
            e.copy_(s)

    def _load_scaler(self, saved, reset_optimizer, filename):
        """The loss scaler's slot, as the JAX trainer merges it: restored
        under ``--fp16`` (fresh with ``--reset-optimizer`` or when the file
        has none), dropped otherwise."""
        if not self.use_scaler:
            if saved is not None:
                logger.warning("checkpoint: dropping %s's loss scaler (not "
                               "training under --fp16)", filename)
            return
        if reset_optimizer:
            return
        if saved is None:
            logger.warning("checkpoint: %s holds no loss scaler; keeping "
                           "the fresh one", filename)
            return
        self.scaler = {
            "scale": torch.tensor(np.asarray(saved["scale"], np.float32),
                                  device=self.device),
            "growth_tracker": torch.tensor(
                np.asarray(saved["growth_tracker"], np.int32),
                device=self.device)}

    def _load_generator(self, saved):
        """Restore the dropout generator's bytes.  A JAX-written file holds
        none (the JAX trainer draws its dropout from the seed and its
        dispatch count, which torch cannot reproduce), and a file written
        on another device type holds another generator's: the generator
        then restarts from ``(seed, num_updates)``, the same seed for
        every resume of one file."""
        current = self.generator.get_state()
        if saved is not None and np.asarray(saved).size == current.numel():
            self.generator.set_state(
                torch.from_numpy(np.array(saved, np.uint8)))
            return
        seed = np.random.SeedSequence(
            [self.seed & 0xFFFFFFFF, self._num_updates])
        self.generator.manual_seed(int(seed.generate_state(1, np.uint64)[0]
                                       >> np.uint64(1)))
        logger.warning("checkpoint holds no torch generator state for this "
                       "device; dropout restarts from (seed %d, update %d)",
                       self.seed, self._num_updates)


def _host(t):
    """A C-contiguous fp32 numpy copy of tensor ``t`` (bf16 widens
    exactly)."""
    t = t.detach().float().contiguous()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def _plain(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return True
    if isinstance(value, (list, tuple)):
        return all(_plain(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in value.items())
    return False


def _plain_args(args):
    """``args`` without values the JAX package could not unpickle
    without torch (a ``torch.dtype``, a device, ...)."""
    return argparse.Namespace(**{k: v for k, v in vars(args).items()
                                 if _plain(v)})
