"""Evoformer example of the port (counterpart of ``examples/evoformer``).

Loaded with ``--user-dir unicore_tpu_torch/examples/evoformer``, which
registers the ``evoformer`` task, the ``evoformer_mse`` loss, the
``evoformer`` model and its ``evoformer``/``evoformer_base``
architectures.  The corpus: ``python -m
unicore_tpu_torch.examples.evoformer.make_data -o DATA``.
"""

from . import loss, model, task  # noqa: F401
