"""The port's prefill flash attention (K7) and RG-LRU scan (K8) held against
the JAX reference.

On the CPU the port's wrappers take the plain versions; they are held
against the reference's Pallas kernels in interpret mode and against its
plain versions, on the shapes of the reference's own kernel tests:
attention within 1e-5 in float32 and 2e-2 in bf16 (the reference's
tolerances; sums are taken in another order), the scan within 1e-5 (the
reference's associative scan sums in another order than the port's
walk).  The tanh GELU the recurrent family uses equals ``jax.nn.gelu``
within 1e-6.  K7's tensor-core variants are held here through a mirror
of their band arithmetic and plain-torch emulations of their numerics
(bf16 products; 3xTF32 split products), K8's chunked walk through a
numpy mirror of its arithmetic, and K8's gated entry on the CPU to the
model's gate math on bits.  The ``cuda``-marked tests hold each kernel
against its plain version on the card.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import ops as jfops
from repro.kernels.rglru import ops as jrops

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.flash_attention import (
    TILES, band_pairs, flash_attention_fwd, key_band, pick_variant,
    tile_needs_mask)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rglru import ops as rops
from repro_torch.kernels.rglru.ref import rglru_gated_scan_ref, rglru_scan_ref
from repro_torch.kernels.rglru.rglru import SERIAL_MAX_S, scan_chunks
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
    tiles of the variant it launches and masks the padded keys; under a
    causal mask the padded keys lie after every real query, so attention
    over the padded operands cut back to S rows equals attention over the
    unpadded ones, at each variant's tiles."""
    for tiles in TILES.values():
        s = tiles.bq + 5
        q, k, v = (torch.from_numpy(x) for x in _qkv(2, 4, 2, s, 12))
        pad_q, pad_k = (-s) % tiles.bq, (-s) % tiles.bkv
        padded = attention_ref(
            torch.nn.functional.pad(q, (0, 0, 0, pad_q)),
            torch.nn.functional.pad(k, (0, 0, 0, pad_k)),
            torch.nn.functional.pad(v, (0, 0, 0, pad_k)), causal=True,
            window=16)[:, :, :s]
        torch.testing.assert_close(padded, fops.flash_attention(
            q, k, v, causal=True, window=16), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 256, "tf32x3"),
    (torch.bfloat16, 12, "simt"), (torch.bfloat16, 264, "simt")])
def test_flash_pick_variant(dtype, d, variant):
    assert pick_variant(dtype, d) == variant


# (S, window) pairs the band mirror is held on: whole and ragged tiles,
# windows shorter than, equal to and longer than S, and the 9B cell.
BAND_GRID = [(64, 0), (100, 0), (200, 100), (320, 128), (320, 100),
             (1024, 2048), (1000, 300), (2560, 2048)]


@pytest.mark.parametrize("tiles", [TILES["wgmma"], TILES["simt"],
                                   TILES["tf32x3"]],
                         ids=["bq128", "bq64", "bq64k32"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_band_visits_each_pair_once(tiles, causal):
    """The kernels' band arithmetic (key_band per group of rows, masks only
    on tiles tile_needs_mask names): every (query, key) pair the masks allow
    lies in exactly one visited tile, every tile left unmasked holds only
    allowed pairs, and the allowed pairs visited number band_pairs."""
    for s, window in BAND_GRID:
        sq = -(-s // tiles.bq) * tiles.bq
        sk_pad = -(-s // tiles.bkv) * tiles.bkv
        i = np.arange(sq)[:, None]
        j = np.arange(sk_pad)[None, :]
        allowed = (j < s) & np.ones((sq, 1), bool)
        if causal:
            allowed &= j <= i
        if window > 0:
            allowed &= i - j < window
        visits = np.zeros((sq, sk_pad), np.int32)
        for r0 in range(0, sq, tiles.group_rows):
            rows = slice(r0, r0 + tiles.group_rows)
            lo, hi = key_band(r0, tiles.group_rows, s, causal, window,
                              tiles.bkv)
            for kt in range(lo, hi):
                keys = slice(kt * tiles.bkv, (kt + 1) * tiles.bkv)
                visits[rows, keys] += 1
                if not tile_needs_mask(r0, tiles.group_rows, kt * tiles.bkv,
                                       s, causal, window, tiles.bkv):
                    assert allowed[rows, keys].all(), (s, window, r0, kt)
        assert visits.max() <= 1
        assert (visits[allowed] == 1).all(), (s, window)
        assert int(visits[:s][allowed[:s]].sum()) == band_pairs(
            s, s, causal, window)


def _emulate_wgmma(q, k, v, *, causal, window, scale):
    """The wgmma variant's numerics in plain torch: bf16 operands, float32
    sums, 64-row groups over their band of 64-key tiles, scores times
    scale * log2(e) with -1e30 added only on tiles that need a mask, an
    online softmax with exp2, P rounded to bf16 before P V, out = acc /
    max(l, 1e-30)."""
    tiles = TILES["wgmma"]
    b, h, s, d = q.shape
    g = h // k.shape[1]
    sq = -(-s // tiles.bq) * tiles.bq
    sk_pad = -(-s // tiles.bkv) * tiles.bkv
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, sq - s))
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, sk_pad - s))
              .repeat_interleave(g, 1) for t in (k, v))
    c = torch.tensor(scale * np.log2(np.e), dtype=torch.float32)
    out = torch.zeros((b, h, sq, d))
    for r0 in range(0, sq, tiles.group_rows):
        rows = torch.arange(r0, r0 + tiles.group_rows)[:, None]
        qg = qf[:, :, r0:r0 + tiles.group_rows]
        m = torch.full(qg.shape[:-1], -1e30)
        l = torch.zeros(qg.shape[:-1])
        acc = torch.zeros(qg.shape)
        lo, hi = key_band(r0, tiles.group_rows, s, causal, window, tiles.bkv)
        for kt in range(lo, hi):
            k0 = kt * tiles.bkv
            keys = slice(k0, k0 + tiles.bkv)
            t = (qg @ kf[:, :, keys].transpose(-1, -2)) * c
            if tile_needs_mask(r0, tiles.group_rows, k0, s, causal, window,
                               tiles.bkv):
                j = torch.arange(k0, k0 + tiles.bkv)[None, :]
                masked = (j >= s).expand(tiles.group_rows, -1)
                if causal:
                    masked = masked | (j > rows)
                if window > 0:
                    masked = masked | (rows - j >= window)
                t = t + torch.where(masked, -1e30, 0.0)
            m_new = torch.maximum(m, t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(t - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (
                p.to(torch.bfloat16).float() @ vf[:, :, keys])
            m = m_new
        out[:, :, r0:r0 + tiles.group_rows] = acc / torch.clamp_min(
            l, 1e-30)[..., None]
    return out[:, :, :s].to(torch.bfloat16)


@pytest.mark.parametrize("magnitude", [1.0, 12.0])
def test_flash_wgmma_numerics_within_gate(magnitude):
    """The wgmma variant's arithmetic, emulated, stays inside the chip
    gate's 1e-2 + 1e-2*|ref| of the port's plain version and of the JAX
    reference's, at the 9B model's head_dim with a window that is not a
    multiple of the key tile, with ordinary and with large scores."""
    q, k, v = _qkv(1, 4, 1, 320, 256, seed=5)
    q, k = q * magnitude, k * magnitude
    tq, tk, tv = (_as_torch(x, "bfloat16") for x in (q, k, v))
    got = _emulate_wgmma(tq, tk, tv, causal=True, window=100,
                         scale=256 ** -0.5).float()
    ref = attention_ref(tq, tk, tv, causal=True, window=100).float()
    jref = _f32(jfops.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=True, window=100, use_ref=True))
    for want in (ref, torch.from_numpy(jref)):
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= 1e-2 + 1e-2 * want.abs()).all())


def _tf32(x):
    """cvt.rna.tf32.f32 on finite float32: round to nearest, ties away from
    zero, at 10 mantissa bits, on the int32 view (the kernel's rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dot3(a, b):
    """a @ b as the tf32x3 variant takes it: each operand split into
    big = rna(x) and small = rna(x - big), big.big plus the cross products
    small.big + big.small (float32 products; small.small dropped)."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return ab @ bb + (as_ @ bb + ab @ bs)


def _emulate_tf32x3(q, k, v, *, causal, window, scale):
    """The tf32x3 variant's numerics in plain torch: float32 operands, q
    times the scale, 64-row q tiles over their band of 32-key tiles, the
    -1e30 masks only on tiles that need them, both products in 3xTF32, an
    online softmax with exp over each half of every tile's keys (the two
    warps of a row group), the halves merged at the end, out = acc /
    max(l, 1e-30)."""
    tiles = TILES["tf32x3"]
    b, h, s, d = q.shape
    g = h // k.shape[1]
    sq = -(-s // tiles.bq) * tiles.bq
    sk_pad = -(-s // tiles.bkv) * tiles.bkv
    qf = F.pad(q.float() * scale, (0, 0, 0, sq - s))
    kf, vf = (F.pad(t.float(), (0, 0, 0, sk_pad - s)).repeat_interleave(g, 1)
              for t in (k, v))
    out = torch.zeros((b, h, sq, d))
    for r0 in range(0, sq, tiles.group_rows):
        rows = torch.arange(r0, r0 + tiles.group_rows)[:, None]
        qg = qf[:, :, r0:r0 + tiles.group_rows]
        half = tiles.bkv // 2
        m = [torch.full(qg.shape[:-1], -1e30) for _ in range(2)]
        l = [torch.zeros(qg.shape[:-1]) for _ in range(2)]
        acc = [torch.zeros(qg.shape) for _ in range(2)]
        lo, hi = key_band(r0, tiles.group_rows, s, causal, window, tiles.bkv)
        for kt in range(lo, hi):
            k0 = kt * tiles.bkv
            masked_tile = tile_needs_mask(r0, tiles.group_rows, k0, s,
                                          causal, window, tiles.bkv)
            for w, h0 in enumerate((k0, k0 + half)):
                keys = slice(h0, h0 + half)
                t = _dot3(qg, kf[:, :, keys].transpose(-1, -2))
                if masked_tile:
                    j = torch.arange(h0, h0 + half)[None, :]
                    masked = (j >= s).expand(tiles.group_rows, -1)
                    if causal:
                        masked = masked | (j > rows)
                    if window > 0:
                        masked = masked | (rows - j >= window)
                    t = t + torch.where(masked, -1e30, 0.0)
                m_new = torch.maximum(m[w], t.amax(-1))
                corr = torch.exp(m[w] - m_new)
                p = torch.exp(t - m_new[..., None])
                l[w] = l[w] * corr + p.sum(-1)
                acc[w] = acc[w] * corr[..., None] + _dot3(p, vf[:, :, keys])
                m[w] = m_new
        mx = torch.maximum(m[0], m[1])
        c0, c1 = torch.exp(m[0] - mx), torch.exp(m[1] - mx)
        den = torch.clamp_min(l[0] * c0 + l[1] * c1, 1e-30)
        out[:, :, r0:r0 + tiles.group_rows] = (
            acc[0] * c0[..., None] + acc[1] * c1[..., None]) / den[..., None]
    return out[:, :, :s]


@pytest.mark.parametrize("b,h,kh,s,d,window", [
    (1, 4, 1, 320, 256, 0),      # the 9B model's head_dim, causal
    (2, 4, 1, 100, 12, 8)])      # the reduced config's head_dim
def test_flash_tf32x3_numerics_within_gate(b, h, kh, s, d, window):
    """The tf32x3 variant's arithmetic, emulated, stays inside the chip
    gate's 1e-5 + 1e-5*|ref| of the port's plain version and of the JAX
    reference's, in float32 (one TF32 product would not)."""
    q, k, v = _qkv(b, h, kh, s, d, seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = _emulate_tf32x3(tq, tk, tv, causal=True, window=window,
                          scale=d ** -0.5)
    ref = attention_ref(tq, tk, tv, causal=True, window=window)
    jref = _f32(jfops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=True, window=window,
                                      use_ref=True))
    for want in (ref, torch.from_numpy(jref)):
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    one = (tq * d ** -0.5) @ tk.repeat_interleave(h // kh, 1).transpose(-1,
                                                                         -2)
    assert float((_tf32(tq * d ** -0.5) @ _tf32(tk).repeat_interleave(
        h // kh, 1).transpose(-1, -2) - one).abs().max()) > 1e-4


def test_launch_check_counts_variants():
    """A K7 launch counts once under the kernel and once under its
    variant; a failed launch raises and counts nothing."""
    _build.reset_launch_counts()
    _build.check("flash_prefill", 0, "wgmma")
    _build.check("flash_prefill", 0, "wgmma")
    _build.check("flash_prefill", 0, "simt")
    with pytest.raises(RuntimeError, match="wgmma"):
        _build.check("flash_prefill", 1, "wgmma")
    assert _build.launch_counts()["flash_prefill"] == 3
    assert _build.variant_counts("flash_prefill") == {"wgmma": 2, "simt": 1}
    _build.reset_launch_counts()
    assert _build.variant_counts("flash_prefill") == {}


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


def _fma(x, y, z):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def _chunk_scan_mirror(a, b, h0):
    """K8's walk (csrc/rglru_scan.cu) in numpy: rounds of warps * steps
    from scan_chunks(S), steps past S as the identity; each warp walks its
    steps from zero (local end value and product of its a's), the round's
    carry is folded through the partials of the warps before it, in warp
    order, and each warp walks its steps again from its carry-in; h_last
    is h at step S - 1."""
    bsz, s, r = a.shape
    warps, steps = scan_chunks(s)
    rnd = warps * steps
    pad = -(-s // rnd) * rnd - s
    a = np.concatenate([a, np.ones((bsz, pad, r), np.float32)], 1)
    b = np.concatenate([b, np.zeros((bsz, pad, r), np.float32)], 1)
    out = np.empty_like(a)
    carry = h0.astype(np.float32)
    for t0 in range(0, s + pad, rnd):
        part_a, part_b = [], []
        for w in range(warps):
            pa = np.ones((bsz, r), np.float32)
            pb = np.zeros((bsz, r), np.float32)
            for t in range(t0 + w * steps, t0 + (w + 1) * steps):
                pb = _fma(a[:, t], pb, b[:, t])
                pa = pa * a[:, t]
            part_a.append(pa)
            part_b.append(pb)
        for w in range(warps):
            c = carry
            for j in range(w):
                c = _fma(part_a[j], c, part_b[j])
            for t in range(t0 + w * steps, t0 + (w + 1) * steps):
                c = _fma(a[:, t], c, b[:, t])
                out[:, t] = c
        carry = c
    return out[:, :s], out[:, s - 1]


@pytest.mark.parametrize("b,s,r", SCAN_SHAPES + [(2, 77, 64), (3, 5, 32)])
def test_rglru_chunk_mirror_matches_jax(b, s, r):
    """K8's chunked arithmetic, mirrored on the CPU, within 1e-5 of the
    reference's Pallas kernel (interpret mode), on its shapes, at an S that
    is not a multiple of a round and at one the direct walk takes."""
    a, bb, h0 = _scan_inputs(b, s, r)
    jh, jlast = jrops.rglru_scan(jnp.asarray(a), jnp.asarray(bb),
                                 jnp.asarray(h0), interpret=True)
    h, last = _chunk_scan_mirror(a, bb, h0)
    np.testing.assert_allclose(h, np.asarray(jh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(last, np.asarray(jlast), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(last, h[:, -1])


def test_rglru_scan_chunks_read_only_s():
    """The plan is a function of S alone, so a row's bits do not depend on
    the batch it is launched in: the mirror gives rows 0 and B-1 at B = 1
    the same bits as at B = 3."""
    assert list(inspect.signature(scan_chunks).parameters) == ["s"]
    assert scan_chunks(1) == scan_chunks(SERIAL_MAX_S) == (1, 1)
    warps, steps = scan_chunks(SERIAL_MAX_S + 1)
    assert warps > 1 and steps > 1 and scan_chunks(4096) == (warps, steps)
    with pytest.raises(ValueError):
        scan_chunks(0)
    for s in (5, 77, 130):
        a, bb, h0 = _scan_inputs(3, s, 64, seed=s)
        h, last = _chunk_scan_mirror(a, bb, h0)
        for i in (0, 2):
            h1, last1 = _chunk_scan_mirror(a[i:i + 1], bb[i:i + 1],
                                           h0[i:i + 1])
            np.testing.assert_array_equal(h1, h[i:i + 1])
            np.testing.assert_array_equal(last1, last[i:i + 1])


def _gated_inputs(b, s, r, ydt=torch.bfloat16, seed=9):
    rng = np.random.RandomState(seed)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    r_g, i_g = (torch.from_numpy(sig(rng.standard_normal((b, s, r)))
                                 .astype(np.float32)) for _ in range(2))
    y = torch.from_numpy(rng.standard_normal((b, s, r)).astype(
        np.float32)).to(ydt)
    lam = torch.from_numpy((-4.38 + 0.5 * rng.standard_normal(r)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, r)).astype(np.float32))
    return r_g, i_g, y, lam, h0


@pytest.mark.parametrize("ydt", [torch.bfloat16, torch.float32])
def test_rglru_gated_cpu_bits_equal_model_math(ydt):
    """On the CPU the gated entry is the model's gate math, op by op in its
    order, then the plain scan: bit-equal to the RG-LRU the model computed
    before the entry existed; a given h_last (h0 itself too) receives the
    last state."""
    r_g, i_g, y, lam, h0 = _gated_inputs(2, 7, 16, ydt)
    log_a = -8.0 * F.softplus(lam) * r_g
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i_g * y.float())
    want_h, want_last = rglru_scan_ref(a, gated, h0)
    _build.reset_launch_counts()
    got_h, got_last = rops.rglru_gated_scan(r_g, i_g, y, lam, h0)
    assert _build.launch_counts()["rglru_scan"] == 0
    assert torch.equal(got_h, want_h) and torch.equal(got_last, want_last)
    state = h0.clone()
    seq, last = rops.rglru_gated_scan(r_g, i_g, y, lam, state, h_last=state)
    assert last is state and torch.equal(seq, want_h)
    assert torch.equal(state, want_last)
    for got, want in zip(rglru_gated_scan_ref(r_g, i_g, y, lam, h0),
                         (want_h, want_last)):
        assert torch.equal(got, want)


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
@pytest.mark.parametrize("dtype,b,h,d,s,causal,window,variant", [
    ("bfloat16", 2, 4, 256, 320, True, 128, "wgmma"),   # the 9B model's heads
    ("float32", 2, 4, 128, 200, True, 0, "tf32x3"),     # padded tail
    ("float32", 2, 4, 12, 100, True, 8, "tf32x3"),      # the reduced config
    ("float32", 2, 4, 256, 320, True, 100, "tf32x3"),   # the 9B model's heads
    ("float32", 2, 4, 10, 100, False, 0, "tf32x3"),     # head_dim % 4 != 0
    ("bfloat16", 2, 4, 64, 128, False, 0, "wgmma"),
    ("bfloat16", 2, 4, 128, 200, True, 0, "wgmma"),     # S not a multiple of 128
    ("bfloat16", 2, 4, 256, 320, True, 100, "wgmma"),   # window not a multiple of 64
    ("bfloat16", 2, 4, 96, 200, False, 0, "wgmma"),     # a zero-filled half chunk
    ("bfloat16", 1, 16, 256, 2560, True, 2048, "wgmma"),  # the 9B cell at B 1
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, b, h, d, s,
                                            causal, window, variant):
    q, k, v = (_as_torch(x, dtype).to(cuda_device)
               for x in _qkv(b, h, 1, s, d))
    _build.reset_launch_counts()
    got = fops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_prefill"] == 1
    assert _build.variant_counts("flash_prefill") == {variant: 1}
    ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,d,s,causal,window", [
    ("float32", 2, 4, 128, 200, True, 0),    # padded tail
    ("float32", 2, 4, 12, 100, True, 8),     # the reduced config
    ("bfloat16", 2, 4, 12, 100, True, 8),    # bf16 head_dim % 16 != 0
    ("bfloat16", 2, 4, 24, 200, False, 0),
])
def test_flash_simt_matches_plain_on_card(cuda_device, dtype, b, h, d, s,
                                          causal, window):
    """The SIMT variant, which serves bf16 head_dims that are not a
    multiple of 16 and is float32's yardstick, against the plain version
    at padded, reduced-config and unaligned shapes."""
    q, k, v = (_as_torch(x, dtype).to(cuda_device)
               for x in _qkv(b, h, 1, s, d))
    tiles = TILES["simt"]
    qp, kp, vp = (F.pad(t, (0, 0, 0, (-s) % n))
                  for t, n in ((q, tiles.bq), (k, tiles.bkv), (v, tiles.bkv)))
    _build.reset_launch_counts()
    got = flash_attention_fwd(qp, kp, vp, sk=s, causal=causal, window=window,
                              scale=d ** -0.5, variant="simt")[:, :, :s]
    torch.cuda.synchronize()
    assert _build.variant_counts("flash_prefill") == {"simt": 1}
    ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.cuda
def test_flash_rows_independent_of_batch_on_card(cuda_device):
    """A row's bits do not depend on the batch it is launched in."""
    q, k, v = (_as_torch(x, "bfloat16").to(cuda_device)
               for x in _qkv(4, 16, 1, 320, 256, seed=3))
    full = fops.flash_attention(q, k, v, causal=True, window=100)
    for i in range(4):
        one = fops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   causal=True, window=100)
        assert torch.equal(_bits(one), _bits(full[i:i + 1])), i


@pytest.mark.cuda
def test_flash_tf32x3_rows_and_simt_on_card(cuda_device):
    """float32 through tf32x3: a row's bits do not depend on the batch;
    the SIMT variant, kept as its yardstick, still holds the plain
    version's 1e-5 on the same operands."""
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(4, 16, 1, 320, 256, seed=8))
    full = fops.flash_attention(q, k, v, causal=True, window=0)
    for i in (0, 3):
        one = fops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   causal=True, window=0)
        assert torch.equal(one.view(torch.int32),
                           full[i:i + 1].contiguous().view(torch.int32)), i
    _build.reset_launch_counts()
    simt = flash_attention_fwd(q, k, v, sk=320, causal=True, window=0,
                               scale=256 ** -0.5, variant="simt")
    torch.cuda.synchronize()
    assert _build.variant_counts("flash_prefill") == {"simt": 1}
    ref = attention_ref(q, k, v, causal=True, window=0)
    for got in (full, simt):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
def test_flash_causal_prefix_on_card(cuda_device, window):
    """Under a causal mask the first L rows of a sequence equal, on bits,
    the attention of its prefix of length L (other q tiles, padding and
    sk; the same rows)."""
    q, k, v = (_as_torch(x, "bfloat16").to(cuda_device)
               for x in _qkv(2, 4, 1, 320, 256, seed=4))
    full = fops.flash_attention(q, k, v, causal=True, window=window)
    for n in (100, 128, 200):
        pre = fops.flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n],
                                   causal=True, window=window)
        assert torch.equal(_bits(pre), _bits(full[:, :, :n])), n


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(4, 1, 4096), (3, 300, 257)])
def test_rglru_kernel_matches_plain_on_card(cuda_device, b, s, r):
    a, bb, h0 = (torch.from_numpy(x).to(cuda_device)
                 for x in _scan_inputs(b, s, r))
    _build.reset_launch_counts()
    h, last = rops.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert _build.launch_counts()["rglru_scan"] == 1
    assert _build.variant_counts("rglru_scan") == {"scan": 1}
    assert torch.equal(last, h[:, -1])
    rh, rlast = rglru_scan_ref(a, bb, h0)
    torch.testing.assert_close(h, rh, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(last, rlast, atol=1e-5, rtol=1e-5)
    for i in (0, b - 1):
        h1, last1 = rops.rglru_scan(a[i:i + 1], bb[i:i + 1], h0[i:i + 1])
        assert torch.equal(h1, h[i:i + 1]) and torch.equal(last1,
                                                           last[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(4, 1, 4096), (3, 300, 257),
                                   (2, 8, 96), (1, 65, 32)])
@pytest.mark.parametrize("ydt", [torch.bfloat16, torch.float32])
def test_rglru_gated_kernel_matches_plain_on_card(cuda_device, b, s, r, ydt):
    """K8's gated entry against the gate math and plain scan on the card
    (1e-5 + 1e-5*|ref|), one launch; rows at B = 1 equal rows at B = b on
    bits; h_last written over h0 equals a fresh h_last."""
    r_g, i_g, y, lam, h0 = (t.to(cuda_device)
                            for t in _gated_inputs(b, s, r, ydt))
    _build.reset_launch_counts()
    h, last = rops.rglru_gated_scan(r_g, i_g, y, lam, h0)
    torch.cuda.synchronize()
    assert _build.variant_counts("rglru_scan") == {"gated": 1}
    assert torch.equal(last, h[:, -1])
    rh, rlast = rglru_gated_scan_ref(r_g, i_g, y, lam, h0)
    torch.testing.assert_close(h, rh, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(last, rlast, atol=1e-5, rtol=1e-5)
    for i in (0, b - 1):
        h1, last1 = rops.rglru_gated_scan(r_g[i:i + 1], i_g[i:i + 1],
                                          y[i:i + 1], lam, h0[i:i + 1])
        assert torch.equal(h1, h[i:i + 1]) and torch.equal(last1,
                                                           last[i:i + 1])
    state = h0.clone()
    seq, out = rops.rglru_gated_scan(r_g, i_g, y, lam, state, h_last=state)
    assert out is state and torch.equal(seq, h) and torch.equal(state, last)
