"""Carry BERT's weights between the JAX package and the port.

:func:`state_dict_from_flax` is the inverse of the JAX package's
``BERT_RULES`` (``unicore_tpu/tools/convert_torch_checkpoint.py``): it
turns a flax ``BertModel`` param tree (nested dict of arrays) into the
port's ``state_dict`` under the reference torch names, so the same
weights run in both packages.  :func:`flax_from_state_dict` goes the
other way, to exactly the tree, paths and shapes that
``arch_flax_params("bert", ...)`` gives.  The tied LM projection has no
tensor of its own, as in the reference.  A classification head
``classification_heads.{name}.*`` is ``classification_heads_{name}/*``
in flax, as the JAX converter maps it.
"""

from ..lm.convert import (_qkv_weight, apply_inverse_rules, apply_rules,
                          inverse_items, linear_kernel, qkv_bias, qkv_kernel)

_L = r"sentence_encoder/layers_(\d+)"
_RULES = [
    (r"embed_tokens/embedding", "embed_tokens.weight", None),
    (r"embed_positions", "embed_positions.weight", None),
    (r"sentence_encoder/(emb_layer_norm|final_layer_norm)/(weight|bias)",
     "sentence_encoder.{0}.{1}", None),
    (r"sentence_encoder/relative_attention_bias/weight",
     "sentence_encoder.relative_attention_bias.weight", None),
    (_L + r"/self_attn/in_proj/kernel",
     "sentence_encoder.layers.{0}.self_attn.in_proj.weight", _qkv_weight),
    (_L + r"/self_attn/in_proj/bias",
     "sentence_encoder.layers.{0}.self_attn.in_proj.bias",
     lambda b: b.reshape(-1)),
    (_L + r"/(self_attn/out_proj|fc1|fc2)/kernel",
     "sentence_encoder.layers.{0}.{1}.weight", lambda k: k.T),
    (_L + r"/(self_attn/out_proj|fc1|fc2)/bias",
     "sentence_encoder.layers.{0}.{1}.bias", None),
    (_L + r"/(self_attn_layer_norm|final_layer_norm)/(weight|bias)",
     "sentence_encoder.layers.{0}.{1}.{2}", None),
    (r"lm_head/dense/kernel", "lm_head.dense.weight", lambda k: k.T),
    (r"lm_head/dense/bias", "lm_head.dense.bias", None),
    (r"lm_head/layer_norm/(weight|bias)", "lm_head.layer_norm.{0}", None),
    (r"lm_head/bias", "lm_head.bias", None),
    (r"classification_heads_([^/]+)/(dense|out_proj)/kernel",
     "classification_heads.{0}.{1}.weight", lambda k: k.T),
    (r"classification_heads_([^/]+)/(dense|out_proj)/bias",
     "classification_heads.{0}.{1}.bias", None),
]


_P = r"sentence_encoder\.layers\.(\d+)"
_INVERSE_RULES = [
    # (port name regex, flax path template, transform(value, heads))
    (r"embed_tokens\.weight", "embed_tokens/embedding", None),
    (r"embed_positions\.weight", "embed_positions", None),
    (r"sentence_encoder\.(emb_layer_norm|final_layer_norm)\.(weight|bias)",
     "sentence_encoder/{0}/{1}", None),
    (r"sentence_encoder\.relative_attention_bias\.weight",
     "sentence_encoder/relative_attention_bias/weight", None),
    (_P + r"\.self_attn\.in_proj\.weight",
     "sentence_encoder/layers_{0}/self_attn/in_proj/kernel", qkv_kernel),
    (_P + r"\.self_attn\.in_proj\.bias",
     "sentence_encoder/layers_{0}/self_attn/in_proj/bias", qkv_bias),
    (_P + r"\.(self_attn\.out_proj|fc1|fc2)\.weight",
     "sentence_encoder/layers_{0}/{1}/kernel", linear_kernel),
    (_P + r"\.(self_attn\.out_proj|fc1|fc2)\.bias",
     "sentence_encoder/layers_{0}/{1}/bias", None),
    (_P + r"\.(self_attn_layer_norm|final_layer_norm)\.(weight|bias)",
     "sentence_encoder/layers_{0}/{1}/{2}", None),
    (r"lm_head\.dense\.weight", "lm_head/dense/kernel", linear_kernel),
    (r"lm_head\.dense\.bias", "lm_head/dense/bias", None),
    (r"lm_head\.layer_norm\.(weight|bias)", "lm_head/layer_norm/{0}", None),
    (r"lm_head\.bias", "lm_head/bias", None),
    (r"classification_heads\.([^.]+)\.(dense|out_proj)\.weight",
     "classification_heads_{0}/{1}/kernel", linear_kernel),
    (r"classification_heads\.([^.]+)\.(dense|out_proj)\.bias",
     "classification_heads_{0}/{1}/bias", None),
]


def state_dict_from_flax(params):
    """Flax ``BertModel`` params -> the port's ``state_dict`` (float32 CPU
    tensors).  Raises on a parameter no rule maps."""
    return apply_rules(params, _RULES)


def flax_from_state_dict(state_dict, heads):
    """The port's ``state_dict`` -> the flax ``BertModel`` tree (numpy
    arrays).  Raises on a tensor no rule maps."""
    return apply_inverse_rules(state_dict, _INVERSE_RULES, heads)


def flax_items(state_dict, heads):
    """Names, flax paths and flax-layout views of the port's tensors
    (:func:`~unicore_tpu_torch.examples.lm.convert.inverse_items`)."""
    return inverse_items(state_dict, _INVERSE_RULES, heads)
