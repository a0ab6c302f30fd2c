"""Token selection for the serve engine (counterpart of
``unicore_tpu/serve/sampling.py``): greedy only for now.

Temperature and top-k sampling wait for a later slice: the JAX engine
keys them by ``fold_in(PRNGKey(seed), step)`` threefry bits, which a
``torch.Generator`` cannot reproduce, so they need a counter-based
per-(seed, step) generator of their own.  The engine refuses a request
with ``temperature > 0`` until then.
"""

import torch


def finite_rows(logits):
    """Per-row health of the logits a token is sampled from: bool [B],
    False where ANY entry of the row is NaN/Inf.  The engine quarantines
    such a row on the host while the rest of the batch continues."""
    return torch.isfinite(logits.float()).all(dim=-1)


def greedy_tokens(logits):
    """Argmax per row, int64 [B]; ties go to the first index, as
    ``jnp.argmax``."""
    return torch.argmax(logits.float(), dim=-1)
