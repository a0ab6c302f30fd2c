"""Train a model with the PyTorch port (counterpart of
``unicore_tpu_cli/train.py``)::

    python -m unicore_tpu_torch.cli.train DATA \\
        --user-dir unicore_tpu_torch/examples/bert --task bert \\
        --loss masked_lm --arch bert_base --pre-tokenized --bf16 --no-save ...

The epoch loop groups ``--update-freq`` micro-batches per update, logs
the ``train_inner`` meters every ``--log-interval`` updates and the epoch
averages at each epoch's end, validates every
``--validate-interval-updates`` updates, at each epoch's end and when
training stops, and stops at ``--max-update`` or ``--max-epoch``.
Checkpointing is not ported yet (ROADMAP.md A7): a run without
``--no-save`` exits with a message saying so.
"""

import json
import logging
import os
import sys
import time

import torch

from .. import options, tasks
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
    def __init__(self, args, trainer, task):
        self.args = args
        self.trainer = trainer
        self.task = task
        self.log = _Log(args)
        self.valid_losses = []

    def _stop(self, epoch_itr):
        args, n = self.args, self.trainer.get_num_updates()
        if args.max_update > 0 and n >= args.max_update:
            return True
        return args.max_epoch > 0 and epoch_itr.epoch >= args.max_epoch \
            and epoch_itr.end_of_epoch()

    def run(self, epoch_itr):
        while True:
            if self.args.max_epoch > 0 and \
                    epoch_itr.next_epoch_idx > self.args.max_epoch:
                break
            stop = self.train_epoch(epoch_itr)
            if stop:
                break

    def train_epoch(self, epoch_itr):
        args = self.args
        itr = epoch_itr.next_epoch_itr()
        freqs = args.update_freq
        update_freq = freqs[min(epoch_itr.epoch, len(freqs)) - 1]
        grouped = iterators.GroupedIterator(itr, update_freq)
        self.trainer.begin_epoch(epoch_itr.epoch)
        prefix = f"epoch {epoch_itr.epoch:03d}"
        stop = False
        for samples in grouped:
            with metrics.aggregate("train_inner"):
                self.trainer.train_step(samples)
            n = self.trainer.get_num_updates()
            if n % args.log_interval == 0:
                stats = metrics.get_smoothed_values("train_inner")
                self.log(f"{prefix}: {grouped.n:5d} / {len(grouped)}", stats,
                         "train_inner", n)
                metrics.reset_meters("train_inner")
            end_of_epoch = not itr.has_next()
            stop = self._stop(epoch_itr)
            vi = args.validate_interval_updates
            if not args.disable_validation and (
                    stop or end_of_epoch or (vi > 0 and n % vi == 0)):
                self.validate(epoch_itr)
            if stop:
                break
        logger.info("end of epoch %d (average epoch stats below)",
                    epoch_itr.epoch)
        self.log(prefix, metrics.get_smoothed_values("train"), "train",
                 self.trainer.get_num_updates())
        metrics.reset_meters("train")
        return stop

    def validate(self, epoch_itr):
        args = self.args
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
            self.log(f"epoch {epoch_itr.epoch:03d} | valid on '{subset}' "
                     "subset", stats, subset, stats["num_updates"])
            self.valid_losses.append(stats.get("loss"))


def main(args):
    if not args.no_save:
        raise SystemExit(
            "unicore_tpu_torch.cli.train: checkpointing is not ported yet "
            "(ROADMAP.md A7); pass --no-save")
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
    epoch_itr = trainer.get_train_iterator(epoch=1)
    t0 = time.perf_counter()
    loop = TrainLoop(args, trainer, task)
    loop.run(epoch_itr)
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

