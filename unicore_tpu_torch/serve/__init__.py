"""``unicore_tpu_torch.serve`` — continuous-batching inference over a
paged KV pool, in PyTorch (counterpart of ``unicore_tpu/serve``).

Modules: ``kv_pool`` (page accounting), ``scheduler`` (admission,
eviction, shedding), ``attention`` (paged attention dispatch),
``sampling`` (greedy), ``engine`` (:class:`ServeEngine`), ``cli``
(``python -m unicore_tpu_torch.serve``).  The package init imports
nothing, so the attention modules can reach ``serve.attention`` without
pulling in the engine.
"""
