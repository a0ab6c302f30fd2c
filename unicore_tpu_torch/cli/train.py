"""Train a model with the PyTorch port (counterpart of
``unicore_tpu_cli/train.py``)::

    python -m unicore_tpu_torch.cli.train DATA \\
        --user-dir unicore_tpu_torch/examples/bert --task bert \\
        --loss masked_lm --arch bert_base --pre-tokenized --bf16 ...

The epoch loop groups ``--update-freq`` micro-batches per update, logs
the ``train_inner`` meters every ``--log-interval`` updates and the epoch
averages at each epoch's end, and after every update decides, as the
reference's ``validate_and_save`` does, whether to validate and whether
to save.  A run resumes from ``<save-dir>/checkpoint_last.pt`` when there
is one (:class:`~unicore_tpu_torch.checkpoint_utils.CheckpointManager`),
and stops at ``--max-update``, ``--max-epoch`` or ``--patience``.
"""

import json
import logging
import math
import os
import sys
import time

import torch

from .. import options, tasks
from ..checkpoint_utils import CheckpointManager
from ..data import iterators
from ..logging import metrics
from ..trainer import Trainer

logger = logging.getLogger("unicore_tpu_torch.cli.train")


class _Log:
    """Writes the log lines (``--log-format``) and, with
    ``--tensorboard-logdir``, one JSON record per line to
    ``<logdir>/<tag>.jsonl``."""

    def __init__(self, args):
        self.fmt = args.log_format
        self.logdir = args.tensorboard_logdir or None
        if self.logdir:
            os.makedirs(self.logdir, exist_ok=True)

    def __call__(self, prefix, stats, tag, step):
        if self.fmt == "json":
            logger.info(json.dumps({"tag": tag, "step": step, **stats}))
        elif self.fmt == "simple":
            body = ", ".join(f"{k}={v}" for k, v in stats.items())
            logger.info("%s | %s", prefix, body)
        if self.logdir:
            with open(os.path.join(self.logdir, f"{tag}.jsonl"), "a") as f:
                f.write(json.dumps({"step": step, **stats}) + "\n")


class TrainLoop:
    def __init__(self, args, trainer, task, ckpt):
        self.args = args
        self.trainer = trainer
        self.task = task
        self.ckpt = ckpt
        self.log = _Log(args)
        self.valid_losses = []
        self._runs_without_improvement = 0
        self._patience_best = None

    def _hit_hard_limits(self):
        max_update = self.args.max_update or math.inf
        return self.trainer.get_num_updates() >= max_update

    def _stop(self, epoch_itr):
        args = self.args
        return self._hit_hard_limits() or (
            args.max_epoch > 0 and epoch_itr.epoch >= args.max_epoch
            and epoch_itr.end_of_epoch())

    def _patience_exhausted(self, valid_loss):
        if valid_loss is None or self.args.patience <= 0:
            return False
        if (self._patience_best is None
                or (valid_loss > self._patience_best
                    if self.args.maximize_best_checkpoint_metric
                    else valid_loss < self._patience_best)):
            self._patience_best = valid_loss
            self._runs_without_improvement = 0
            return False
        self._runs_without_improvement += 1
        if self._runs_without_improvement >= self.args.patience:
            logger.info("early stop: no validation improvement in the last "
                        "%d runs", self.args.patience)
            return True
        return False

    def run(self, epoch_itr):
        while not (self.args.max_epoch > 0
                   and epoch_itr.next_epoch_idx > self.args.max_epoch):
            valid_losses, stop = self.train_epoch(epoch_itr)
            if stop:
                break
            self.trainer.lr_step(epoch_itr.epoch, valid_losses[0])

    def train_epoch(self, epoch_itr):
        """One epoch of updates; returns (valid_losses, should_stop)."""
        args = self.args
        # a resumed run may already sit at its limit (its last save was
        # the final one): train no update past it
        if self._hit_hard_limits():
            return [None], True
        itr = epoch_itr.next_epoch_itr()
        freqs = args.update_freq
        update_freq = freqs[min(epoch_itr.epoch, len(freqs)) - 1]
        grouped = iterators.GroupedIterator(itr, update_freq)
        self.trainer.begin_epoch(epoch_itr.epoch)
        prefix = f"epoch {epoch_itr.epoch:03d}"
        valid_losses, stop = [None], False
        for samples in grouped:
            with metrics.aggregate("train_inner"):
                self.trainer.train_step(samples)
            n = self.trainer.get_num_updates()
            if n % args.log_interval == 0:
                stats = metrics.get_smoothed_values("train_inner")
                self.log(f"{prefix}: {grouped.n:5d} / {len(grouped)}", stats,
                         "train_inner", n)
                metrics.reset_meters("train_inner")
            valid_losses, stop = self.validate_and_save(
                epoch_itr, end_of_epoch=not grouped.has_next())
            if stop:
                break
        logger.info("end of epoch %d (average epoch stats below)",
                    epoch_itr.epoch)
        self.log(prefix, metrics.get_smoothed_values("train"), "train",
                 self.trainer.get_num_updates())
        metrics.reset_meters("train")
        return valid_losses, stop

    def validate_and_save(self, epoch_itr, end_of_epoch):
        """The reference's condition trees: what this update owes — a
        checkpoint, a validation pass, both or neither."""
        args = self.args
        # a background write that failed since the last boundary surfaces
        # here, before anything else
        self.ckpt.poll()
        updates = self.trainer.get_num_updates()
        stop = self._stop(epoch_itr)
        save_now = stop or (
            end_of_epoch and epoch_itr.epoch % args.save_interval == 0
            and not args.no_epoch_checkpoints
        ) or (
            args.save_interval_updates > 0 and updates > 0
            and updates % args.save_interval_updates == 0
            and updates >= getattr(args, "validate_after_updates", 0))
        vi = args.validate_interval_updates
        validate_now = not args.disable_validation and (
            stop or (not end_of_epoch and save_now)
            or (end_of_epoch
                and epoch_itr.epoch % getattr(args, "validate_interval", 1)
                == 0 and not args.no_epoch_checkpoints)
            or (vi > 0 and updates > 0 and updates % vi == 0))
        valid_losses = [None]
        if validate_now:
            valid_losses = self.validate(epoch_itr)
        stop |= self._patience_exhausted(valid_losses[0])
        self.ckpt.save(self.trainer, epoch_itr, valid_losses[0],
                       do_save=save_now or stop)
        return valid_losses, stop

    def validate(self, epoch_itr):
        """Every validation subset; returns the checkpoint-metric values."""
        args = self.args
        losses = []
        for subset in args.valid_subset.split(","):
            itr = self.trainer.get_valid_iterator(subset).next_epoch_itr(
                shuffle=False)
            with metrics.aggregate(new_root=True) as agg:
                for sample in itr:
                    logs = self.trainer.valid_step(sample)
                    self.task.reduce_metrics(logs, self.trainer.loss,
                                             "valid")
            stats = agg.get_smoothed_values()
            stats["num_updates"] = self.trainer.get_num_updates()
            metric = args.best_checkpoint_metric
            if self.ckpt.best.value is not None and metric in stats:
                fold = max if args.maximize_best_checkpoint_metric else min
                stats[f"best_{metric}"] = fold(self.ckpt.best.value,
                                               stats[metric])
            self.log(f"epoch {epoch_itr.epoch:03d} | valid on '{subset}' "
                     "subset", stats, subset, stats["num_updates"])
            self.valid_losses.append(stats.get("loss"))
            if metric in stats:
                losses.append(stats[metric])
        return losses or [None]


def main(args):
    if args.num_workers > 0:
        raise NotImplementedError(
            "--num-workers > 0: the port loads batches inline; data worker "
            "pools are not ported yet (ROADMAP.md A4)")
    torch.manual_seed(args.seed)
    metrics.reset()
    task = tasks.setup_task(args)
    if not args.disable_validation:
        for subset in args.valid_subset.split(","):
            task.load_dataset(subset)
    model = task.build_model(args)
    loss = task.build_loss(args)
    trainer = Trainer(args, task, model, loss, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model %s, %d parameters, device %s, compute dtype %s",
                args.arch, n_params, trainer.device, trainer.compute_dtype)
    ckpt = CheckpointManager(args, is_master=True)
    _, epoch_itr = ckpt.restore(trainer)
    t0 = time.perf_counter()
    loop = TrainLoop(args, trainer, task, ckpt)
    try:
        loop.run(epoch_itr)
        # every background save must land (or raise) before success
        ckpt.drain()
    finally:
        ckpt.close()
    logger.info("done training in %.1f seconds", time.perf_counter() - t0)
    return loop


def cli_main(input_args=None):
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_training_parser(input_args)
    args = options.parse_args_and_arch(parser, input_args)
    return main(args)


if __name__ == "__main__":
    cli_main()

