"""The port's prefill flash attention (K7) and RG-LRU scan (K8) held against
the JAX reference.

On the CPU the port's wrappers take the plain versions; they are held
against the reference's Pallas kernels in interpret mode and against its
plain versions, on the shapes of the reference's own kernel tests:
attention within 1e-5 in float32 and 2e-2 in bf16 (the reference's
tolerances; sums are taken in another order), the scan within 1e-5 (the
reference's associative scan sums in another order than the port's
walk).  The tanh GELU the recurrent family uses equals ``jax.nn.gelu``
within 1e-6.  The ``cuda``-marked tests hold each kernel against its
plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfops
from repro.kernels.rglru import ops as jrops

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.flash_attention import BKV, BQ
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru import ops as rops
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models import layers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(b, h, kh, s, d, seed=7):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))


def _as_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# The reference's grid (tests/test_flash_rglru_kernels.py): S, D, group,
# causal, window; two KV heads.
FLASH_GRID = [(128, 128, 1, True, 0), (256, 128, 4, True, 0),
              (256, 128, 2, True, 64), (128, 128, 1, False, 0),
              (192, 128, 1, True, 0)]


@pytest.mark.parametrize("s,d,g,causal,window", FLASH_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(s, d, g, causal, window, dtype):
    kh = 2
    q, k, v = _qkv(1, kh * g, kh, s, d)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    kern = jfops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 interpret=True)
    ref = jfops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                use_ref=True)
    got = fops.flash_attention(_as_torch(q, dtype), _as_torch(k, dtype),
                               _as_torch(v, dtype), causal=causal,
                               window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    for want in (kern, ref):
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_padding_is_cut_back():
    """The CUDA route pads q to whole query tiles and k/v to whole key
    tiles and masks the padded keys; under a causal mask the padded keys
    lie after every real query, so attention over the padded operands cut
    back to S rows equals attention over the unpadded ones."""
    s = BQ + 5
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, s, 12))
    pad_q, pad_k = (-s) % BQ, (-s) % BKV
    padded = attention_ref(
        torch.nn.functional.pad(q, (0, 0, 0, pad_q)),
        torch.nn.functional.pad(k, (0, 0, 0, pad_k)),
        torch.nn.functional.pad(v, (0, 0, 0, pad_k)), causal=True,
        window=16)[:, :, :s]
    torch.testing.assert_close(padded, fops.flash_attention(
        q, k, v, causal=True, window=16), rtol=1e-5, atol=1e-5)


# The reference's four scan shapes: batch, steps, width.
SCAN_SHAPES = [(2, 128, 128), (3, 100, 256), (8, 256, 128), (1, 64, 384)]


def _scan_inputs(b, s, r, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.8, 0.999, (b, s, r)).astype(np.float32),
            (rng.standard_normal((b, s, r)) * 0.1).astype(np.float32),
            rng.standard_normal((b, r)).astype(np.float32))


@pytest.mark.parametrize("b,s,r", SCAN_SHAPES)
def test_rglru_plain_matches_jax(b, s, r):
    a, bb, h0 = _scan_inputs(b, s, r)
    jh, jlast = jrops.rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                                 jnp.asarray(h0), interpret=True)
    h, last = rops.rglru_scan(*(torch.from_numpy(x) for x in (a, bb, h0)))
    assert h.dtype == last.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("lo,hi", [(-6.0, 6.0), (-40.0, 40.0)])
def test_gelu_matches_jax(lo, hi):
    x = np.linspace(lo, hi, 4097, dtype=np.float32)
    np.testing.assert_allclose(
        layers.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_wrappers_take_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 16, 8))
    a, bb, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 5, 8))
    _build.reset_launch_counts()
    fops.flash_attention(q, k, v, causal=True, window=4)
    rops.rglru_scan(a, bb, h0)
    counts = _build.launch_counts()
    assert counts["flash_prefill"] == counts["rglru_scan"] == 0
    h, last = rglru_scan_ref(a, bb, h0)
    assert torch.equal(last, h[:, -1])
    assert torch.equal(h[:, 0], a[:, 0] * h0 + bb[:, 0])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,s,causal,window", [
    ("bfloat16", 256, 320, True, 128),    # the 9B model's heads, 16-byte loads
    ("float32", 128, 200, True, 0),       # padded tail, 16-byte loads
    ("float32", 12, 100, True, 8),        # the reduced config: scalar loads
    ("bfloat16", 64, 128, False, 0),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, d, s,
                                            causal, window):
    q, k, v = (_as_torch(x, dtype).to(cuda_device)
               for x in _qkv(2, 4, 1, s, d))
    _build.reset_launch_counts()
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_prefill"] == 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(4, 1, 4096), (3, 300, 257)])
def test_rglru_kernel_matches_plain_on_card(cuda_device, b, s, r):
    a, bb, h0 = (torch.from_numpy(x).to(cuda_device)
                 for x in _scan_inputs(b, s, r))
    _build.reset_launch_counts()
    h, last = rops.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert _build.launch_counts()["rglru_scan"] == 1
    rh, rlast = rglru_scan_ref(a, bb, h0)
    torch.testing.assert_close(h, rh, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(last, rlast, atol=1e-5, rtol=1e-5)
