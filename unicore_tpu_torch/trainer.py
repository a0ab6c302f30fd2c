"""Training step of the port (counterpart of ``unicore_tpu/trainer.py``,
the part the BERT path runs).

One update: the micro-batches of ``--update-freq`` run forward and
backward one after another, their summed losses' gradients accumulate in
fp32, then the gradients are divided by the summed sample size, their
global norm is taken, they are clipped to ``--clip-norm``, and the
optimizer steps — unless the norm is not finite, in which case the update
is skipped (params and moments untouched) and, as in the reference
without a loss scaler, the step raises ``FloatingPointError``.

``--bf16`` keeps fp32 master parameters and runs forward and backward on
a bf16 copy of the model refreshed from them before each update (the
reference casts its fp32 params to bf16 for each micro-batch's forward;
round-to-nearest gives the same copy each time); the copy's gradients
fold into the fp32 master gradients.  ``--bf16-sr`` refreshes the copy
by stochastic rounding before every micro-batch instead, with fresh
seeds, as the reference's step does; ``--optim-bf16-moments`` stores
Adam's moments in bf16, re-quantized by stochastic rounding.

Flags of the JAX trainer this slice does not port raise
``NotImplementedError`` naming their ``ROADMAP.md`` item
(:func:`refuse_unported`); none is ignored.
"""

import copy
import logging
import math

import torch

from .device import resolve_device
from .logging import metrics
from .optim import build_optimizer
from .optim.fp16_optimizer import sync_master_to_model
from .optim.lr_scheduler import build_lr_scheduler

logger = logging.getLogger(__name__)

# (attribute, value meaning "off", flag, ROADMAP.md item)
UNPORTED = (
    ("fp16", False, "--fp16", "A6"),
    ("ema_decay", -1.0, "--ema-decay", "A7"),
    ("zero1", False, "--zero1", "A8"),
    ("comms_overlap", False, "--comms-overlap", "A8"),
    ("fsdp_size", 1, "--fsdp-size", "A13"),
    ("fsdp", False, "--fsdp", "A13"),
    ("tensor_parallel_size", 1, "--tensor-parallel-size", "A13"),
    ("seq_parallel_size", 1, "--seq-parallel-size", "A13"),
    ("pack_sequences", False, "--pack-sequences", "A11"),
    ("per_sample_clip_norm", 0.0, "--per-sample-clip-norm", "A7"),
    ("checkpoint_activations", False, "--checkpoint-activations", "A3"),
)


def refuse_unported(args):
    """Raise ``NotImplementedError`` for the first flag that asks for a
    feature this slice has not ported."""
    for attr, off, flag, item in UNPORTED:
        value = getattr(args, attr, off)
        if value is not None and value != off:
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch trainer yet "
                f"(ROADMAP.md {item})")


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
        self.compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) \
            else torch.float32
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
        self.seed = int(getattr(args, "seed", 1))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.optimizer = build_optimizer(args, list(self.model.parameters()))
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

    # -- one update --------------------------------------------------------

    def _sync_compute_params(self, stochastic=False):
        """Refresh the compute copy from the master params: round to
        nearest, or stochastically with fresh seeds."""
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
        self.compute_model.train()
        self.optimizer.set_lr(self.lr_scheduler.step_update(self._num_updates))
        if not self.bf16_sr:
            self._sync_compute_params()
        for p in self.model.parameters():
            p.grad = None
        sample_size = torch.zeros((), device=self.device)
        logs = {}
        for sample in samples:
            if self.bf16_sr:
                self._sync_compute_params(stochastic=True)
            sample = _to_device(sample, self.device)
            loss, ss, log = self.loss(self.compute_model, sample,
                                      generator=self.generator)
            loss.float().backward()
            self._fold_compute_grads()
            sample_size = sample_size + ss
            for k, v in log.items():
                logs[k] = logs.get(k, 0.0) + v
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        torch._foreach_div_(grads, torch.clamp(sample_size, min=1.0))
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.clip_norm > 0:
            torch._foreach_mul_(
                grads, torch.clamp(self.clip_norm / (grad_norm + 1e-6),
                                   max=1.0))
        grad_norm = float(grad_norm)
        if not math.isfinite(grad_norm):
            metrics.log_scalar("n_skipped", 1, priority=600, round=0)
            raise FloatingPointError(
                f"Non-finite gradients detected (grad norm {grad_norm}); "
                "the update was skipped")
        if getattr(self.optimizer, "wants_update_rng", False):
            self.optimizer.step(generator=self.generator)
        else:
            self.optimizer.step()
        self.set_num_updates(self._num_updates + 1)
        logging_outputs = [logs]
        self._reduce_and_log_stats(logging_outputs, float(sample_size),
                                   grad_norm)
        return logging_outputs

    @torch.no_grad()
    def valid_step(self, sample):
        """Loss of one validation batch, dropout off."""
        self._sync_compute_params()
        self.compute_model.eval()
        sample = _to_device(sample, self.device)
        _, _, log = self.loss(self.compute_model, sample)
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

    def get_train_iterator(self, epoch):
        self.task.load_dataset(self.args.train_subset, epoch=epoch)
        return self.task.get_batch_iterator(
            self.task.dataset(self.args.train_subset),
            batch_size=self.args.batch_size,
            required_batch_size_multiple=self.args.required_batch_size_multiple,
            seed=self.seed, epoch=epoch)

    def get_valid_iterator(self, subset):
        return self.task.get_batch_iterator(
            self.task.dataset(subset),
            batch_size=self.args.batch_size,
            required_batch_size_multiple=self.args.required_batch_size_multiple,
            seed=self.seed)
