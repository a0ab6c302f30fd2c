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
"""

import torch.nn.functional as F
from torch import nn


class FlaxDense(nn.Linear):
    """``nn.Linear`` (same ``weight``/``bias`` names and layout) whose
    bias is added after the product is rounded to x's dtype."""

    def forward(self, x):
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias
