"""Paged attention of the PyTorch port (unicore_tpu_torch/ops/
paged_attention.py) against the JAX package: its plain version vs
``paged_attention_reference`` and vs the Pallas ragged kernel run in
interpret mode, on a mixed batch (prefill chunk, decode row, short
chunk with -1 tail positions, inactive row), plus the CUDA kernel vs the
plain version where a card is present.

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
