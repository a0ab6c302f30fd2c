"""Evoformer pair-stack example of the port (counterpart of
``examples/pair``).

Loaded with ``--user-dir unicore_tpu_torch/examples/pair``, which
registers the ``pair`` task, the ``pair_mse`` loss, the
``evoformer_pair`` model and its ``evoformer_pair``/``evoformer_pair_base``
architectures.  The corpus: ``python -m
unicore_tpu_torch.examples.pair.make_data -o DATA``.
"""

from . import loss, model, task  # noqa: F401
