"""``unicore_tpu_torch`` — the PyTorch/CUDA port of ``unicore_tpu``.

A second package beside the JAX one, brought up slice by slice and held
against it by tests that run both on the same inputs and weights.  It
imports ``torch`` and numpy only: never ``jax``, ``flax``, or anything of
``unicore_tpu``/``examples``.

Implemented so far: the serve path — a decoder LM
(``examples.lm.model``) behind the continuous-batching engine over a
paged KV pool (``serve``), whose paged attention is a hand-written CUDA
kernel for Hopper (``csrc/paged_attention.cu``, bound in
``ops.paged_attention``).

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
