"""Uni-Mol pretraining example of the port (counterpart of
``examples/mol``).

Loaded with ``--user-dir unicore_tpu_torch/examples/mol``, which
registers the ``mol`` task, the ``unimol`` loss, the ``unimol`` model and
its ``unimol``/``unimol_base`` architectures.  The corpus: ``python -m
unicore_tpu_torch.examples.mol.make_data -o DATA``.
"""

from . import loss, model, task  # noqa: F401
