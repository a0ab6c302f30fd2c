"""BERT masked-LM example of the port (counterpart of ``examples/bert``).

Loaded with ``--user-dir unicore_tpu_torch/examples/bert``, which
registers the ``bert`` task, the ``bert`` model and its ``bert``/
``bert_base`` architectures.
"""

from . import model, task  # noqa: F401
