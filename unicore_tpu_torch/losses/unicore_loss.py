"""Loss base class of the port (counterpart of
``unicore_tpu/losses/unicore_loss.py``).

``loss.forward(model, sample, generator=None)`` returns ``(loss,
sample_size, logging_output)``: ``loss`` is the SUM over the micro-batch
(the trainer normalizes by the summed sample size), ``logging_output`` a
flat dict of scalars that sum across micro-batches — tensors, read on
the host only when logged.  The
model's ``training`` flag decides whether dropout is on; ``generator``
feeds it.
"""


def fused_head_request(loss, model):
    """``(want_fused, chunk_override)``: the fused chunked linear + cross
    entropy head is requested when ``--fused-lm-head`` is not "off" (the
    default is on) and the model declares ``supports_fused_head``;
    ``chunk_override`` is ``--fused-ce-chunk`` (0/None = auto)."""
    args = getattr(loss, "args", None)
    enabled = str(getattr(args, "fused_lm_head", None) or "on") != "off"
    if not (enabled and getattr(model, "supports_fused_head", False)):
        return False, None
    chunk = int(getattr(args, "fused_ce_chunk", 0) or 0)
    return True, (chunk if chunk > 0 else None)


class UnicoreLoss:
    def __init__(self, task):
        self.task = task
        self.args = task.args if task is not None else None

    @classmethod
    def add_args(cls, parser):
        """Add loss-specific arguments to the parser."""

    @classmethod
    def build_loss(cls, args, task):
        return cls(task)

    def forward(self, model, sample, generator=None):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    @staticmethod
    def reduce_metrics(logging_outputs, split="train"):
        raise NotImplementedError

    @staticmethod
    def logging_outputs_can_be_summed(is_train):
        """Whether the logging outputs of ``forward`` can be summed across
        examples before ``reduce_metrics`` (``--per-sample-clip-norm``
        needs it, as in the JAX trainer)."""
        return False
