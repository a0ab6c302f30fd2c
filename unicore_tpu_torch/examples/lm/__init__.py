"""Causal decoder LM example of the port (counterpart of
``examples/lm``).

Loaded with ``--user-dir unicore_tpu_torch/examples/lm``, which
registers the ``lm`` task, the ``lm_cross_entropy`` loss, the
``transformer_lm`` model and its ``transformer_lm``/``transformer_lm_base``
architectures.  The serve engine runs the same model.  A corpus:
``python -m unicore_tpu_torch.examples.lm.make_data -o DATA``.
"""

from . import loss, model, task  # noqa: F401
