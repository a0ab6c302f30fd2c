"""Linear layer that rounds as flax's ``nn.Dense`` rounds (counterpart of
the ``nn.Dense``/``nn.DenseGeneral`` projections of
``unicore_tpu/modules/transformer_encoder.py`` and
``multihead_attention.py``).

flax forms ``x @ kernel`` in x's dtype, then adds the bias in that dtype:
under bf16 the product rounds to bf16 before the bias add, and the sum
rounds again.  ``nn.Linear`` adds the bias inside the one rounding of
the product (on the CPU, and on the card through cuBLAS's bias
epilogue), so in bf16 about a quarter of its outputs land one ulp off
flax's.  In fp32 the two agree to the last bits.

Mixed types promote as flax's ``promote_dtype`` does: x, kernel and bias
all go to the widest of their types, in which the product and the bias
add run (Uni-Mol's fp32 Gaussian features meet an fp16 kernel under
``--fp16``: the projection runs in fp32).  Where the types agree nothing
is cast.
"""

import torch
import torch.nn.functional as F
from torch import nn


class FlaxDense(nn.Linear):
    """``nn.Linear`` (same ``weight``/``bias`` names and layout) whose
    bias is added after the product is rounded to the promoted type."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype != w.dtype or (b is not None and b.dtype != w.dtype):
            dtype = torch.promote_types(x.dtype, w.dtype)
            if b is not None:
                dtype = torch.promote_types(dtype, b.dtype)
                b = b.to(dtype)
            x, w = x.to(dtype), w.to(dtype)
        y = F.linear(x, w)
        return y if b is None else y + b
