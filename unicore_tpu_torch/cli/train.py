"""Train a model with the PyTorch port (counterpart of
``unicore_tpu_cli/train.py``)::

    python -m unicore_tpu_torch.cli.train DATA \\
        --user-dir unicore_tpu_torch/examples/bert --task bert \\
        --loss masked_lm --arch bert_base --pre-tokenized --bf16 ...

The epoch loop groups ``--update-freq`` micro-batches per update (the
batch order unshuffled for the first ``--curriculum`` epochs), logs the
``train_inner`` meters every ``--log-interval`` updates and the epoch
averages at each epoch's end through the progress bar of
``--log-format``, and after every update decides, as the reference's
``validate_and_save`` does, whether to validate (``--batch-size-valid``,
at most ``--max-valid-steps`` + 1 batches a subset) and whether to save.
A run resumes from ``<save-dir>/checkpoint_last.pt`` when there is one
(:class:`~unicore_tpu_torch.checkpoint_utils.CheckpointManager`), and
stops at ``--max-update``, ``--max-epoch``, ``--patience``,
``--stop-time-hours`` (training time summed over the runs it resumes) or
before an epoch whose lr is at or below ``--stop-min-lr``.  SIGTERM or
SIGINT (unless ``--no-graceful-shutdown``) saves a checkpoint at the
next update's boundary and exits 0.  ``--profile`` writes a
``torch.profiler`` Chrome trace of the run to ``<save-dir>/torch_trace/``.
Batches load on ``--num-workers`` workers of ``--worker-impl`` (threads
or forked processes; the reference's defaults, 1 thread) ahead of the
loop by ``--data-buffer-size`` batches, and a run closes its workers on
the way out, a preempted one too.

Data parallelism (:func:`~unicore_tpu_torch.distributed.call_main`): one
rank per card, spawned here when ``--distributed-world-size`` asks for
more than one (default: every visible card; on the CPU, ``--device cpu
--distributed-world-size N`` runs N gloo ranks), or one rank of a group
that ``--distributed-init-method`` names.  Rank 0 logs, writes the
main checkpoint file and the ``--tensorboard-logdir`` records; the
ranks agree on every stop.
"""

import logging
import math
import os
import sys
import time

import torch

from .. import options, tasks
from ..checkpoint_utils import CheckpointManager
from ..data import iterators
from ..distributed import utils as distributed_utils
from ..logging import metrics, progress_bar
from ..resilience.preemption import GracefulShutdown
from ..trainer import Trainer

logger = logging.getLogger("unicore_tpu_torch.cli.train")


class TrainLoop:
    """Drives epochs: train, validate, checkpoint, decide when to stop."""

    def __init__(self, args, trainer, task, ckpt, shutdown=None):
        self.args = args
        self.trainer = trainer
        self.task = task
        self.ckpt = ckpt
        self.shutdown = shutdown  # GracefulShutdown, or None
        self._runs_without_improvement = 0
        self._patience_best = None

    def _hit_hard_limits(self):
        """--max-update and --stop-time-hours, checked after every
        update."""
        updates = self.trainer.get_num_updates()
        max_update = self.args.max_update or math.inf
        if updates >= max_update:
            logger.info("stopping: num_updates %d >= --max-update %s",
                        updates, max_update)
            return True
        if self.args.stop_time_hours > 0:
            hours = self.trainer.cumulative_training_time() / 3600.0
            if hours > self.args.stop_time_hours:
                logger.info("stopping: %.2f training hours > "
                            "--stop-time-hours %s", hours,
                            self.args.stop_time_hours)
                return True
        return False

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
        """Epoch loop until a stop condition fires."""
        max_epoch = self.args.max_epoch or math.inf
        lr = self.trainer.get_lr()
        while epoch_itr.next_epoch_idx <= max_epoch:
            if lr <= self.args.stop_min_lr:
                logger.info("stopping: lr %g <= --stop-min-lr %g", lr,
                            self.args.stop_min_lr)
                break
            valid_losses, stop = self.train_epoch(epoch_itr)
            if stop:
                break
            lr = self.trainer.lr_step(epoch_itr.epoch, valid_losses[0])

    def train_epoch(self, epoch_itr):
        """One epoch of updates; returns (valid_losses, should_stop)."""
        args = self.args
        # a resumed run may already sit at its limit (its last save was
        # the final one): train no update past it
        if self._hit_hard_limits():
            return [None], True
        itr = epoch_itr.next_epoch_itr(
            shuffle=epoch_itr.next_epoch_idx > args.curriculum)
        freqs = args.update_freq
        update_freq = freqs[min(epoch_itr.epoch, len(freqs)) - 1]
        grouped = iterators.GroupedIterator(itr, update_freq)
        progress = self._progress(grouped, epoch_itr.epoch)
        self.trainer.begin_epoch(epoch_itr.epoch)
        valid_losses, stop = [None], False
        for samples in progress:
            with metrics.aggregate("train_inner"):
                self.trainer.train_step(samples)
            n = self.trainer.get_num_updates()
            if n % args.log_interval == 0:
                stats = _with_wall(metrics.get_smoothed_values("train_inner"))
                progress.log(stats, tag="train_inner", step=n)
                metrics.reset_meters("train_inner")
            valid_losses, stop = self.validate_and_save(
                epoch_itr, end_of_epoch=not grouped.has_next())
            if stop:
                break
        logger.info("end of epoch %d (average epoch stats below)",
                    epoch_itr.epoch)
        progress.print(_with_wall(metrics.get_smoothed_values("train")),
                       tag="train", step=self.trainer.get_num_updates())
        metrics.reset_meters("train")
        return valid_losses, stop

    def validate_and_save(self, epoch_itr, end_of_epoch):
        """The reference's condition trees: what this update owes — a
        checkpoint, a validation pass, both or neither.  A requested
        shutdown (SIGTERM, SIGINT) skips validation, saves and stops."""
        args = self.args
        preempted = self.shutdown is not None and self.shutdown.requested
        # a background write that failed since the last boundary surfaces
        # here, before anything else
        self.ckpt.poll()
        if preempted:
            logger.warning("preemption: checkpointing and exiting at this "
                           "step boundary")
        # every rank takes the same decisions (the ranks' clocks and
        # signals may differ)
        preempted = self.trainer.agree(preempted)
        updates = self.trainer.get_num_updates()
        stop = self.trainer.agree(self._hit_hard_limits()) or preempted
        save_now = stop or (
            end_of_epoch and epoch_itr.epoch % args.save_interval == 0
            and not args.no_epoch_checkpoints
        ) or (
            args.save_interval_updates > 0 and updates > 0
            and updates % args.save_interval_updates == 0
            and updates >= args.validate_after_updates)
        vi = args.validate_interval_updates
        validate_now = not args.disable_validation and not preempted and (
            stop or (not end_of_epoch and save_now)
            or (end_of_epoch and epoch_itr.epoch % args.validate_interval == 0
                and not args.no_epoch_checkpoints)
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
            logger.info('begin validation on "%s" subset', subset)
            valid_itr = self.trainer.get_valid_iterator(subset)
            itr = valid_itr.next_epoch_itr(shuffle=False)
            progress = self._progress(itr, epoch_itr.epoch,
                                      prefix=f"valid on '{subset}' subset")
            with metrics.aggregate(new_root=True) as agg:
                logging_outputs = []
                try:
                    for i, sample in enumerate(progress):
                        if (args.max_valid_steps is not None
                                and i > args.max_valid_steps):
                            break
                        logging_outputs.extend(
                            self.trainer.valid_step(sample))
                finally:
                    # the pass's workers and pump, also after an early
                    # stop at --max-valid-steps
                    valid_itr.close()
                self.task.reduce_metrics(
                    self.trainer.gather_logging_outputs(logging_outputs),
                    self.trainer.loss, subset)
            stats = agg.get_smoothed_values()
            stats["num_updates"] = self.trainer.get_num_updates()
            metric = args.best_checkpoint_metric
            if self.ckpt.best.value is not None and metric in stats:
                fold = max if args.maximize_best_checkpoint_metric else min
                stats[f"best_{metric}"] = fold(self.ckpt.best.value,
                                               stats[metric])
            progress.print(stats, tag=subset, step=stats["num_updates"])
            if metric in stats:
                losses.append(stats[metric])
        return losses or [None]

    def _progress(self, itr, epoch, prefix=None):
        return progress_bar.progress_bar(
            itr, log_format=self.args.log_format,
            log_interval=self.args.log_interval, epoch=epoch, prefix=prefix,
            tensorboard_logdir=(self.args.tensorboard_logdir or None)
            if distributed_utils.get_data_parallel_rank() == 0 else None,
            default_log_format=("simple" if self.args.no_progress_bar
                                else "tqdm"))


def _with_wall(stats):
    """``stats`` with the run's wall-clock seconds, as the JAX CLI logs
    them (a checkpoint older than the trainer's ``wall`` meter has
    none)."""
    wall = metrics.get_meter("default", "wall")
    if wall is not None:
        stats["wall"] = round(wall.elapsed_time, 0)
    return stats


def _resolve_batch_size(args, device):
    """``--batch-size-per-device`` times the visible card count (1 on the
    CPU) becomes ``--batch-size`` and the validation batch size's
    fallback; the two flags exclude each other."""
    if args.batch_size_per_device:
        if args.batch_size is not None:
            raise ValueError(
                "--batch-size and --batch-size-per-device are exclusive")
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        args.batch_size = args.batch_size_per_device * n
        args.batch_size_valid = args.batch_size_valid or args.batch_size
        logger.info("--batch-size-per-device %d x %d devices -> "
                    "--batch-size %d", args.batch_size_per_device, n,
                    args.batch_size)


def main(args):
    iterators.set_worker_impl(args.worker_impl)
    if args.cpu:
        args.device = "cpu"
    _resolve_batch_size(args, torch.device(args.device))
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
    ckpt = CheckpointManager(args, is_master=trainer.is_data_parallel_master,
                             rank=trainer.data_parallel_rank)
    trainer.attach_checkpoint_writer(ckpt.writer)
    _, epoch_itr = ckpt.restore(trainer)
    shutdown = (None if args.no_graceful_shutdown
                else GracefulShutdown().install())
    t0 = time.perf_counter()
    loop = TrainLoop(args, trainer, task, ckpt, shutdown=shutdown)
    try:
        loop.run(epoch_itr)
        # every background save must land (or raise) before success; a
        # preemption's checkpoint passes through the same gate
        ckpt.drain()
    finally:
        ckpt.close()
        # the data workers and the prefetch pump go within a deadline, so
        # a preempted run leaves no worker process behind
        epoch_itr.close()
        if shutdown is not None:
            shutdown.uninstall()
    if shutdown is not None and shutdown.requested:
        logger.warning("exiting after preemption checkpoint (%s)",
                       "SIGTERM" if shutdown.signum == 15
                       else str(shutdown.signum))
    logger.info("done training in %.1f seconds", time.perf_counter() - t0)
    return loop


def _profiled(args, fn):
    """``fn(args)`` under ``torch.profiler`` (the CPU, and the card's
    kernels when training on it); the Chrome trace goes to
    ``<save-dir>/torch_trace/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(args.save_dir, "torch_trace")
    prof = profile(activities=activities)
    prof.start()
    try:
        return fn(args)
    finally:
        # a failed run's trace is written too
        prof.stop()
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("profiler trace written to %s", out)


def cli_main(input_args=None):
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO, stream=sys.stdout)
    parser = options.get_training_parser(input_args)
    args = options.parse_args_and_arch(parser, input_args)
    if args.cpu:
        args.device = "cpu"
    return distributed_utils.call_main(
        args, _profiled_main if args.profile else main)


def _profiled_main(args):
    return _profiled(args, main)


if __name__ == "__main__":
    cli_main()
