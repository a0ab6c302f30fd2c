"""Paged attention of the PyTorch port (unicore_tpu_torch/ops/
paged_attention.py) against the JAX package: its plain version vs
``paged_attention_reference`` and vs the Pallas ragged kernel run in
interpret mode, on a mixed batch (prefill chunk, decode row, short
chunk with -1 tail positions, inactive row); the kernel's split plan and
its split-and-merge math against the same; plus the CUDA kernel vs the
plain version where a card is present, at the places a split design
breaks (long rows over many splits, rows that end inside the first
split, head dims and page sizes, bits over two calls).

The JAX side is imported inside the tests, so that the card-only case
can run where JAX is not installed."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from unicore_tpu_torch.ops import build
from unicore_tpu_torch.ops import paged_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mixed_case(rng, B=4, P=5, ps=4, heads=4, d=16, T=3):
    """Numpy operands of one mixed ragged step (as test_serve's
    ``test_ragged_kernel_matches_eager``): row 0 a prefill chunk, row 1 a
    decode row, row 2 inactive (length 0), row 3 a short chunk with a -1
    tail.  Pages are a random permutation of the pool."""
    num_pages = B * P + 1
    k = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    v = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[:B * P] + 1).reshape(B, P)
    lengths = rng.randint(T, P * ps + 1, size=(B,)).astype(np.int32)
    lengths[2] = 0
    positions = np.full((B, T), -1, np.int32)
    positions[0] = np.arange(lengths[0] - T, lengths[0])
    positions[1, 0] = lengths[1] - 1
    positions[3, :2] = [lengths[3] - 2, lengths[3] - 1]
    q = rng.randn(B, T, heads, d).astype(np.float32)
    return q, k, v, table.astype(np.int32), positions, lengths


def plain(case, ps, scale):
    q, k, v, table, positions, lengths = (torch.from_numpy(x) for x in case)
    return pa.paged_attention_plain(q, k, v, table, positions, lengths, ps,
                                    scale).numpy()


@pytest.mark.parametrize("against", ["reference", 1, 2, 3])
def test_plain_matches_jax(rng, against):
    """fp32, atol/rtol 2e-5.  The JAX reference's inactive queries are
    garbage by contract, so only active positions compare; the Pallas
    kernel zeroes them as the port does, so it compares everywhere."""
    import jax.numpy as jnp

    ps, d = 4, 16
    case = mixed_case(rng, ps=ps, d=d)
    scale = d ** -0.5
    got = plain(case, ps, scale)
    assert np.isfinite(got).all()
    q, k, v, table, positions, lengths = (jnp.asarray(x) for x in case)
    if against == "reference":
        from unicore_tpu.serve.attention import paged_attention_reference

        want = np.asarray(paged_attention_reference(
            q, k, v, table, positions, lengths, ps, scale))
        active = case[4] >= 0
        got, want = got[active], want[active]
    else:
        from unicore_tpu.ops.pallas.paged_attention import (
            ragged_paged_attention,
        )

        want = np.asarray(ragged_paged_attention(
            q, k, v, table, positions, lengths, page_size=ps, scale=scale,
            pages_per_block=against))
        assert not got[case[4] < 0].any(), "inactive queries must be 0"
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("batch,heads", [(1, 1), (2, 4), (16, 12), (64, 32)])
@pytest.mark.parametrize("pages,page_size", [(1, 1), (5, 4), (32, 16),
                                             (128, 16), (7, 32), (512, 1)])
def test_split_plan_covers_every_column_once(batch, heads, pages,
                                             page_size):
    """The plan cuts the table's columns into whole ranges that cover
    each column exactly once, none starting past the table, at most 8,
    each a multiple of 64 columns (every tile of the kernel)."""
    cols = pages * page_size
    splits, per = pa.split_plan(batch, heads, cols)
    assert 1 <= splits <= pa.MAX_SPLITS
    assert per > 0 and per % pa.SPLIT_ALIGN == 0
    assert (splits - 1) * per < cols <= splits * per
    hits = np.zeros(cols, np.int64)
    for i in range(splits):
        hits[i * per:min((i + 1) * per, cols)] += 1
    assert (hits == 1).all()
    if batch == 16 and heads == 12 and cols == 512:  # the serve shape
        assert batch * heads * splits >= 2 * 132


def short_first_split_case(rng, per, **kw):
    """``mixed_case`` with row 3's admitted columns all inside the first
    split of ``per`` columns and row 0 running past it."""
    q, k, v, table, positions, lengths = mixed_case(rng, **kw)
    lengths[3] = per - 1
    positions[3, :2] = [per - 3, per - 2]
    lengths[0] = table.shape[1] * kw.get("ps", 4)
    t = positions.shape[1]
    positions[0] = np.arange(lengths[0] - t, lengths[0])
    return q, k, v, table, positions, lengths


@pytest.mark.parametrize("plan", [(1, 20), (2, 10), (3, 8), (4, 6), (5, 4),
                                  (20, 1)])
def test_split_plain_matches_plain(rng, plan):
    """Per-split partials merged by ``combine_partials`` equal the whole
    softmax within 1e-6.  The partial of a split that admits nothing for
    a query is NaN in the helper, so a merge that weighted it through
    ``exp(m - M)`` instead of leaving it out explicitly fails here."""
    ps = 4
    case = short_first_split_case(rng, plan[1], ps=ps)
    t = [torch.from_numpy(x) for x in case]
    got = pa.paged_attention_split_plain(*t, ps, 0.25, plan)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain(case, ps, 0.25),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("plan", [(2, 10), (3, 8), (5, 4)])
def test_split_plain_matches_jax(rng, plan):
    """The split-and-merge math against the Pallas kernel run in
    interpret mode, at every position, atol/rtol 2e-5: an inactive row,
    a -1 tail, a decode row among chunk rows, and a row whose admitted
    columns all lie in the first split."""
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas.paged_attention import (
        ragged_paged_attention,
    )

    ps, d = 4, 16
    case = short_first_split_case(rng, plan[1], ps=ps, d=d)
    assert case[5][3] <= plan[1] and case[5][2] == 0
    scale = d ** -0.5
    got = pa.paged_attention_split_plain(
        *(torch.from_numpy(x) for x in case), ps, scale, plan).numpy()
    want = np.asarray(ragged_paged_attention(
        *(jnp.asarray(x) for x in case), page_size=ps, scale=scale,
        pages_per_block=2))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_combine_leaves_out_empty_splits():
    """Split 1 admits nothing for query 0 and nothing at all for query 1
    (m = -1e30, l = 0, acc unspecified, here NaN): query 0 comes out as
    split 0 alone, query 1 as 0."""
    m = torch.tensor([[[0.5], [pa.NEG]], [[pa.NEG], [pa.NEG]]])
    l = torch.tensor([[[2.0], [0.0]], [[0.0], [0.0]]])
    acc = torch.tensor([[[4.0, 6.0], [torch.nan, torch.nan]],
                        [[torch.nan, 1e30], [torch.nan, torch.nan]]])
    out = pa.combine_partials(m, l, acc)
    np.testing.assert_array_equal(out.numpy(), [[2.0, 3.0], [0.0, 0.0]])


def test_cpu_wrapper_takes_plain_and_never_counts(rng):
    ps = 4
    case = mixed_case(rng, ps=ps)
    before = pa.ragged_paged_attention.launches
    q, k, v, table, positions, lengths = (torch.from_numpy(x) for x in case)
    out = pa.ragged_paged_attention(q, k, v, table, positions, lengths,
                                    page_size=ps, scale=0.25)
    assert pa.ragged_paged_attention.launches == before
    np.testing.assert_array_equal(out.numpy(), plain(case, ps, 0.25))


@pytest.mark.parametrize("bad", ["q_dtype", "index_dtype", "noncontig",
                                 "head_dim"])
def test_kernel_operand_checks_raise(rng, bad):
    """What the kernel does not take is refused before any launch."""
    q, k, v, table, positions, lengths = (
        torch.from_numpy(x) for x in mixed_case(rng, d=16))
    if bad == "q_dtype":
        q = q.double()
    elif bad == "index_dtype":
        table = table.long()
    elif bad == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        q, k, v = q[..., :6].contiguous(), k[..., :6].contiguous(), \
            v[..., :6].contiguous()
    with pytest.raises((TypeError, ValueError)):
        pa._check(q, k, v, table, positions, lengths, 4)


def test_module_imports_without_nvcc_and_build_raises():
    """Importing the kernel's module needs no compiler; a build without
    one raises KernelError instead of falling back."""
    code = (
        "import unicore_tpu_torch.ops.paged_attention as m\n"
        "from unicore_tpu_torch.ops import build\n"
        "try:\n"
        "    build.build(['paged_attention'])\n"
        "except build.KernelError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('build without nvcc did not raise')\n"
    )
    env = dict(os.environ, CUDA_HOME="/nonexistent", PATH="/usr/bin:/bin")
    lib = build.library_path("paged_attention")
    if lib.exists():
        pytest.skip(f"{lib} is already built here")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 3, 32, 40])
def test_kernel_matches_plain_on_card(cuda, T):
    """The CUDA kernel vs the plain version at every position, atol
    1e-4 (fp32, summation order differs): full chunks, a short chunk
    with a -1 tail, a decode row inside a chunk step, an inactive row;
    T = 40 takes two query passes of the block."""
    rng = np.random.RandomState(T)
    B, P, ps, heads, d = 6, 8, 16, 3, 64
    num_pages = B * P + 1
    k = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    v = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[:B * P] + 1).reshape(B, P)
    lengths = rng.randint(T, P * ps + 1, size=(B,)).astype(np.int32)
    lengths[2] = 0
    positions = (lengths[:, None] - T + np.arange(T)).astype(np.int32)
    positions[2] = -1
    positions[4, (T + 1) // 2:] = -1
    lengths[4] = positions[4, (T - 1) // 2] + 1
    positions[5, 1:] = -1
    positions[5, 0] = lengths[5] - 1
    q = rng.randn(B, T, heads, d).astype(np.float32)
    case = (q, k, v, table.astype(np.int32), positions, lengths)
    want = plain(case, ps, d ** -0.5)
    args = [torch.from_numpy(x).to(cuda) for x in case]
    before = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args, page_size=ps, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def card_case(rng, B, T, P, ps, heads, d, short_rows=()):
    """Operands of one ragged step over a table of ``P`` pages: chunk
    rows (the last ``T`` positions of a long row), row 0 filling the
    whole table, a decode row, an inactive row, a short chunk with a -1
    tail; rows in ``short_rows`` end inside the kernel's first split,
    the first of them exactly at its end, while later splits are empty."""
    cols = P * ps
    _, per = pa.split_plan(B, heads, cols)
    num_pages = B * P + 1
    k = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    v = rng.randn(num_pages * ps, heads, d).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[:B * P] + 1).reshape(B, P)
    lengths = rng.randint(max(T, cols // 2), cols + 1,
                          size=(B,)).astype(np.int32)
    lengths[0] = cols
    for i, b in enumerate(short_rows):
        lengths[b] = per if i == 0 else rng.randint(T, per)
    positions = (lengths[:, None] - T + np.arange(T)).astype(np.int32)
    lengths[2] = 0
    positions[2] = -1
    if T > 1:
        positions[1, 1:] = -1
        positions[1, 0] = lengths[1] - 1
        positions[3, (T + 1) // 2:] = -1
        lengths[3] = positions[3, (T - 1) // 2] + 1
    q = rng.randn(B, T, heads, d).astype(np.float32)
    return q, k, v, table.astype(np.int32), positions, lengths


def check_on_card(case, ps):
    """The kernel within 1e-4 of the plain version at every position
    (fp32, summation order differs), one launch a call, and the same
    bits from a second call."""
    d = case[0].shape[-1]
    scale = d ** -0.5
    want = plain(case, ps, scale)
    args = [torch.from_numpy(x).cuda() for x in case]
    before = pa.ragged_paged_attention.launches
    got = pa.ragged_paged_attention(*args, page_size=ps, scale=scale)
    again = pa.ragged_paged_attention(*args, page_size=ps, scale=scale)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 2
    assert torch.equal(got, again), "two calls differ"
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32])
@pytest.mark.parametrize("rows,P,splits", [("long", 128, 8),
                                           ("first_split", 128, 8),
                                           ("one_split", 8, 1)])
def test_split_kernel_matches_plain_on_card(cuda, rows, P, splits, T):
    """Rows of up to 2,048 columns (P = 128, ps = 16) over the plan's 8
    splits; with ``first_split``, rows that end inside the first split
    next to rows that run the whole table; with ``one_split``, a table
    of 128 columns that the plan does not split (no workspace)."""
    rng = np.random.RandomState(T)
    B, ps, heads, d = 8, 16, 3, 64
    assert pa.split_plan(B, heads, P * ps)[0] == splits
    short = (4, 5, 6) if rows == "first_split" else ()
    check_on_card(card_case(rng, B, T, P, ps, heads, d, short), ps)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32])
def test_lengths_past_the_table_stay_in_their_call_on_card(cuda, T):
    """Rows whose lengths and positions run past their table of 2,048
    columns (8 splits): the kernel admits only the table's columns, as
    the plain version does, and every (row, head) still merges, so the
    next call on the same device, with good rows, is right too."""
    rng = np.random.RandomState(10 + T)
    B, P, ps, heads, d = 8, 128, 16, 3, 64
    bad = card_case(rng, B, T, P, ps, heads, d)
    q, k, v, table, positions, lengths = bad
    for b in (0, 4, 5):
        lengths[b] = P * ps + 100 * (b + 1)
        positions[b] = lengths[b] - T + np.arange(T)
    check_on_card(bad, ps)
    check_on_card(card_case(rng, B, T, P, ps, heads, d, (4, 5)), ps)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 32])
@pytest.mark.parametrize("ps,P", [(1, 512), (16, 32), (32, 16)])
@pytest.mark.parametrize("d", [24, 64, 128, 256])
def test_kernel_head_dims_and_page_sizes_on_card(cuda, d, ps, P, T):
    """Every head-dim bucket of the kernel (24 and 64 in the first, 128,
    256) at page sizes 1, 16 and 32 over 512 columns in 4 splits, with
    rows inside the first split next to rows filling the table."""
    rng = np.random.RandomState(d + ps + T)
    B, heads = 8, 3
    assert pa.split_plan(B, heads, P * ps)[0] == 4
    check_on_card(card_case(rng, B, T, P, ps, heads, d, (4, 5)), ps)
