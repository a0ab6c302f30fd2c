"""Activation checkpointing of one layer (the counterpart of the JAX
stacks' ``nn.remat`` under ``checkpoint_activations``): the layer's
activations are dropped after its forward and recomputed in backward.

``torch.utils.checkpoint`` (non-reentrant) keeps the autograd graph as
it is and recomputes the saved tensors when backward first needs them,
so gradients reach the layer's inputs, the shared relative-position
bias among them, in the same order as without checkpointing.  Its
``preserve_rng_state`` saves only the default generators; the port's
dropout draws from the caller's ``torch.Generator`` (residual,
activation and attention dropout, the flash and softmax_dropout seeds).
:func:`remat` therefore records that generator's state before the
layer's forward, replays it for the recompute and then puts back the
state the generator had before the recompute: the recompute draws the
forward's masks and seeds, and the next step draws what it would have
drawn without checkpointing.  The flag changes memory and time, not
the numbers.
"""

from torch.utils.checkpoint import checkpoint


def remat(layer, generator, *args, **kwargs):
    """``layer(*args, **kwargs)`` with its activations recomputed in
    backward; ``generator`` (or None) is the one the layer draws its
    dropout from."""
    if generator is None:
        return checkpoint(layer, *args, use_reentrant=False, **kwargs)
    start = generator.get_state()
    ran = [False]

    def run(*inputs, **kw):
        if not ran[0]:  # the forward
            ran[0] = True
            return layer(*inputs, **kw)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*inputs, **kw)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)
