"""Carry Uni-Mol's weights between the JAX package and the port.

The port names its submodules after the flax modules of
``examples/mol/model.py``, and :func:`state_dict_from_flax` maps the flax
tree one to one: the encoder as BERT's (``encoder/layers_{i}`` to
``encoder.layers.{i}``, in_proj's ``[E, 3, H, Dh]`` kernel to a
``Linear(E, 3E)`` weight), every other ``Dense`` kernel transposed into
``weight``, an ``Embed`` table into ``weight``.
:func:`flax_from_state_dict` goes the other way, to the tree, paths and
shapes of the flax model's own init.
"""

from ..lm.convert import (_qkv_weight, apply_inverse_rules, apply_rules,
                          inverse_items, linear_kernel, qkv_bias, qkv_kernel)

_DENSE = "gbf_proj_in|gbf_proj_out|pair_q|pair_k|pair_mlp|dist_head|coord_head"
_L = r"encoder/layers_(\d+)"
_RULES = [
    # (flax path regex, torch name template, transform)
    (r"gbf/(means|stds)", "gbf.{0}", None),
    (r"gbf/(mul|bias)/embedding", "gbf.{0}.weight", None),
    (r"embed_tokens/embedding", "embed_tokens.weight", None),
    (r"encoder/(emb_layer_norm|final_layer_norm)/(weight|bias)",
     "encoder.{0}.{1}", None),
    (_L + r"/self_attn/in_proj/kernel",
     "encoder.layers.{0}.self_attn.in_proj.weight", _qkv_weight),
    (_L + r"/self_attn/in_proj/bias",
     "encoder.layers.{0}.self_attn.in_proj.bias", lambda b: b.reshape(-1)),
    (_L + r"/(self_attn/out_proj|fc1|fc2)/kernel",
     "encoder.layers.{0}.{1}.weight", lambda k: k.T),
    (_L + r"/(self_attn/out_proj|fc1|fc2)/bias",
     "encoder.layers.{0}.{1}.bias", None),
    (_L + r"/(self_attn_layer_norm|final_layer_norm)/(weight|bias)",
     "encoder.layers.{0}.{1}.{2}", None),
    (r"lm_head/dense/kernel", "lm_head.dense.weight", lambda k: k.T),
    (r"lm_head/(dense/bias|bias)", "lm_head.{0}", None),
    (r"lm_head/norm/(weight|bias)", "lm_head.norm.{0}", None),
    (rf"({_DENSE})/kernel", "{0}.weight", lambda k: k.T),
    (rf"({_DENSE})/bias", "{0}.bias", None),
]

_P = r"encoder\.layers\.(\d+)"
_INVERSE_RULES = [
    # (port name regex, flax path template, transform(value, heads))
    (r"gbf\.(means|stds)", "gbf/{0}", None),
    (r"gbf\.(mul|bias)\.weight", "gbf/{0}/embedding", None),
    (r"embed_tokens\.weight", "embed_tokens/embedding", None),
    (r"encoder\.(emb_layer_norm|final_layer_norm)\.(weight|bias)",
     "encoder/{0}/{1}", None),
    (_P + r"\.self_attn\.in_proj\.weight",
     "encoder/layers_{0}/self_attn/in_proj/kernel", qkv_kernel),
    (_P + r"\.self_attn\.in_proj\.bias",
     "encoder/layers_{0}/self_attn/in_proj/bias", qkv_bias),
    (_P + r"\.(self_attn\.out_proj|fc1|fc2)\.weight",
     "encoder/layers_{0}/{1}/kernel", linear_kernel),
    (_P + r"\.(self_attn\.out_proj|fc1|fc2)\.bias",
     "encoder/layers_{0}/{1}/bias", None),
    (_P + r"\.(self_attn_layer_norm|final_layer_norm)\.(weight|bias)",
     "encoder/layers_{0}/{1}/{2}", None),
    (r"lm_head\.dense\.weight", "lm_head/dense/kernel", linear_kernel),
    (r"lm_head\.(dense\.bias|bias)", "lm_head/{0}", None),
    (r"lm_head\.norm\.(weight|bias)", "lm_head/norm/{0}", None),
    (rf"({_DENSE})\.weight", "{0}/kernel", linear_kernel),
    (rf"({_DENSE})\.bias", "{0}/bias", None),
]


def state_dict_from_flax(params):
    """Flax ``UniMolModel`` params -> the port's ``state_dict`` (float32
    CPU tensors).  Raises on a parameter no rule maps."""
    return apply_rules(params, _RULES)


def flax_from_state_dict(state_dict, heads):
    """The port's ``state_dict`` -> the flax ``UniMolModel`` tree (numpy
    arrays).  Raises on a tensor no rule maps."""
    return apply_inverse_rules(state_dict, _INVERSE_RULES, heads)


def flax_items(state_dict, heads):
    """Names, flax paths and flax-layout views of the port's tensors
    (:func:`~unicore_tpu_torch.examples.lm.convert.inverse_items`)."""
    return inverse_items(state_dict, _INVERSE_RULES, heads)
