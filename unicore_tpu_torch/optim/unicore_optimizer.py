"""Optimizer base class of the port (counterpart of
``unicore_tpu/optim/unicore_optimizer.py``): it owns a list of fp32
master parameters, keeps the host-side learning rate the scheduler sets,
and applies one update in place from the parameters' ``.grad``.
Gradient normalization, clipping and the skip of a non-finite update
live in the trainer."""

import numpy as np
import torch


def foreach_sqrt(tensors):
    """Square roots of fp32 tensors, correctly rounded, out of place: the
    IEEE ``sqrt`` that XLA and the card's ``sqrtf`` compute.  torch's
    vectorized CPU sqrt is not correctly rounded (it is off by an ulp on
    about 0.7% of elements), so CPU tensors take the root in float64,
    which rounds to the same fp32 value as the exact root."""
    if tensors and tensors[0].device.type == "cpu":
        return [torch.sqrt(t.double()).float() for t in tensors]
    return torch._foreach_sqrt(tensors)


class UnicoreOptimizer:
    # the per-parameter entries of the state, the JAX ``opt_state`` keys;
    # each is an attribute holding one tensor a parameter, in order
    state_keys = ()

    def __init__(self, args, params):
        self.args = args
        self.params = [p for p in params if p.requires_grad]
        lr = getattr(args, "lr", 0.0)
        self._lr = float(lr[0]) if isinstance(lr, (list, tuple)) else float(lr)
        self.step_count = 0

    @classmethod
    def add_args(cls, parser):
        """Add optimizer-specific arguments to the parser."""

    @classmethod
    def build_optimizer(cls, args, params):
        return cls(args, params)

    def get_lr(self):
        return self._lr

    def set_lr(self, lr):
        self._lr = float(lr)

    def step(self):
        """One update of ``self.params`` from their ``.grad``."""
        raise NotImplementedError

    def _zeros(self, dtype=torch.float32):
        return [torch.zeros_like(p, dtype=dtype) for p in self.params]

    def state_dict(self):
        """The JAX package's ``opt_state`` shape: ``"step"``, the update
        count as an int32 scalar, and each of :attr:`state_keys` as a
        list of the live tensors, one per parameter in order (the trainer
        maps each list onto the params' flax tree and copies it to the
        host; a bf16 store widens to fp32 there, exactly)."""
        return {"step": np.asarray(self.step_count, np.int32),
                **{key: list(getattr(self, key)) for key in self.state_keys}}

    @torch.no_grad()
    def load_state_dict(self, state_dict):
        """Load :meth:`state_dict`'s shape (entries as lists of arrays or
        tensors in parameter order).  An entry of :attr:`state_keys` that
        ``state_dict`` lacks keeps its current (fresh) value, as the JAX
        trainer's merge keeps a fresh subtree the file does not have.
        Each tensor casts to its store's dtype: exact for values a bf16
        store wrote, whatever their saved dtype."""
        for key in self.state_keys:
            if key not in state_dict:
                continue
            stores, saved = getattr(self, key), state_dict[key]
            if len(saved) != len(stores):
                raise ValueError(f"{key}: {len(saved)} saved leaves for "
                                 f"{len(stores)} parameters")
            for i, (dst, src) in enumerate(zip(stores, saved)):
                if not torch.is_tensor(src):
                    src = torch.from_numpy(np.asarray(src, np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{key}[{i}] has shape "
                                     f"{tuple(src.shape)}, the parameter "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        if "step" in state_dict:
            self.step_count = int(state_dict["step"])
