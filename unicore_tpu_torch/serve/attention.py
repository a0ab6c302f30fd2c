"""Paged attention over page tables: the serve tier's attention core.

Layouts: queries keep the module convention ``[B, T, H, D]``; the pool
is FLAT — ``k_pages``/``v_pages`` are ``[num_slots, H, D]`` where slot
``page * page_size + offset`` holds the token at ``position`` such that
``page == position // page_size`` in that sequence's table.  Gathering a
sequence's pages in table order therefore reproduces its keys in
position order, and causal masking is a plain compare of gathered column
index against the query's position.

The attention itself is ``ops/paged_attention.py``'s
``ragged_paged_attention``, which dispatches by device: a CUDA tensor
launches the hand-written kernel, a CPU tensor takes the plain gather
version.  The JAX package's autotuner and compile probe have no
counterpart: the kernel either launches or raises.
"""

import dataclasses
from typing import Any, List, Tuple


@dataclasses.dataclass
class PagedMeta:
    """Per-step paged-cache operands.

    ``page_table`` [B, P] int32 (rows padded with the trash page 0);
    ``slot_mapping`` [B*T] int64 flat write slots for the current tokens
    (trash slot 0 for padded columns); ``lengths`` [B] int32 valid token
    counts INCLUDING the current tokens; ``page_size`` a Python int;
    ``kv_pages`` one ``(k_pages, v_pages)`` pair of ``[num_slots, H, D]``
    pools per decoder layer, which the step updates IN PLACE (where the
    JAX engine donated them through its jitted step)."""

    page_table: Any
    slot_mapping: Any
    lengths: Any
    page_size: int
    kv_pages: List[Tuple[Any, Any]] = dataclasses.field(default_factory=list)

