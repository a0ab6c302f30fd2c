"""Task base class of the port (counterpart of
``unicore_tpu/tasks/unicore_task.py``): a task owns the dictionary and
datasets, builds the model and the loss, and plans the batches — the
same static plan as the JAX package (size order under a fixed seed,
fixed batch size, whole batches shuffled per epoch)."""

import logging

from ..data import UnicoreDataset, data_utils, iterators, resilient

logger = logging.getLogger(__name__)


class StatefulContainer:
    """Lazy checkpointable task state (a copy of the JAX package's):
    attributes materialize on first access from registered zero-argument
    factories and ride checkpoints verbatim; a restore merges the saved
    dict over whatever has materialized (restored values win)."""

    def __init__(self):
        self._state = {}
        self._factories = {}

    def add_factory(self, name, factory):
        self._factories[name] = factory

    def merge_state_dict(self, state_dict):
        self._state.update(state_dict)

    @property
    def state_dict(self):
        return self._state

    def __getattr__(self, name):
        # only called when normal lookup misses: a state attribute
        state = self.__dict__.get("_state")
        if state is None:  # probed before __init__ (copy, pickle)
            raise AttributeError(name)
        if name not in state:
            factory = self.__dict__["_factories"].get(name)
            if factory is None:
                raise AttributeError(
                    f"Task state has no factory for attribute {name}")
            state[name] = factory()
        return state[name]


class UnicoreTask:
    @classmethod
    def add_args(cls, parser):
        """Add task-specific arguments to the parser."""

    def __init__(self, args, **kwargs):
        self.args = args
        self.datasets = {}
        self.dataset_to_epoch_iter = {}
        self.state = StatefulContainer()

    @classmethod
    def setup_task(cls, args, **kwargs):
        return cls(args, **kwargs)

    def load_dataset(self, split, combine=False, **kwargs):
        raise NotImplementedError

    def dataset(self, split):
        ds = self.datasets.get(split)
        if ds is None:
            raise KeyError(f"Dataset not loaded: {split}")
        if not isinstance(ds, UnicoreDataset):
            raise TypeError(f"split {split!r} holds a {type(ds).__name__}, "
                            "expected a UnicoreDataset")
        return ds

    def can_reuse_epoch_itr(self, dataset):
        return getattr(dataset, "can_reuse_epoch_itr_across_epochs", False)

    def get_batch_iterator(self, dataset, *, batch_size=None,
                           required_batch_size_multiple=1, seed=1, epoch=1,
                           ignore_invalid_inputs=False, num_shards=1,
                           shard_id=0, num_workers=0, data_buffer_size=0,
                           disable_iterator_cache=False):
        """An :class:`~unicore_tpu_torch.data.iterators.EpochBatchIterator`
        over ``dataset`` (the JAX package's signature): the batches are
        grouped once here, size-ordered under a fixed seed at a fixed
        batch size, and each epoch permutes whole batches.  A dataset
        whose epochs replay the same items keeps one iterator across
        calls (``dataset_to_epoch_iter``) unless
        ``disable_iterator_cache``."""
        if not isinstance(dataset, UnicoreDataset):
            raise TypeError(f"expected a UnicoreDataset, got {type(dataset)}")
        # --data-guard: the guarded fetch at the top of the stack, one
        # wrapper per dataset (kept on the task), so the skip log and the
        # budget survive the per-epoch iterator rebuilds
        if not hasattr(self, "_guarded_datasets"):
            self._guarded_datasets = {}
        dataset = resilient.maybe_guard(dataset, self.args, seed=seed,
                                        cache=self._guarded_datasets)
        cacheable = (not disable_iterator_cache
                     and self.can_reuse_epoch_itr(dataset))
        if cacheable:
            cached = self.dataset_to_epoch_iter.get(dataset)
            if cached is not None:
                logger.debug("reusing cached epoch iterator (epoch %d)",
                             epoch)
                return cached
        dataset.set_epoch(epoch)
        with data_utils.numpy_seed(seed):
            order = dataset.ordered_indices()
        plan = dataset.batch_by_size(
            order, batch_size=batch_size,
            required_batch_size_multiple=required_batch_size_multiple)
        epoch_iter = iterators.EpochBatchIterator(
            dataset=dataset, collate_fn=dataset.collater, batch_sampler=plan,
            seed=seed, num_shards=num_shards, shard_id=shard_id,
            num_workers=num_workers, epoch=epoch,
            buffer_size=data_buffer_size,
            disable_shuffling=self.disable_shuffling())
        if cacheable:
            self.dataset_to_epoch_iter[dataset] = epoch_iter
        return epoch_iter

    def disable_shuffling(self):
        return False

    def build_model(self, args):
        from .. import models

        return models.build_model(args, self)

    def build_loss(self, args):
        from .. import losses

        return losses.build_loss(args, self)

    def begin_epoch(self, epoch, model):
        """Hook at the beginning of each epoch."""

    def state_dict(self):
        return self.state.state_dict

    def load_state_dict(self, state_dict):
        self.state.merge_state_dict(state_dict)

    @staticmethod
    def logging_outputs_can_be_summed(loss, is_train):
        """Delegates to the loss; overridable per task."""
        return loss.logging_outputs_can_be_summed(is_train)

    def reduce_metrics(self, logging_outputs, loss, split="train"):
        from ..logging import metrics

        bsz = sum(float(log.get("bsz", 0)) for log in logging_outputs)
        metrics.log_scalar("bsz", bsz, priority=190, round=1)
        loss.__class__.reduce_metrics(logging_outputs, split)
