"""BinGrad's CUDA kernels (``csrc/encode_bingrad.cu``) against their plain
PyTorch versions, and the BinGrad-b paths on the card.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_bingrad_gpu.py

Tolerances, with their reasons:

* Exact cases: values that are multiples of 1/64 in [-1, 1] with d <= 2048
  make every partial sum exact in float32 in any order, so the kernel's
  levels, words, sums and counts are bit-equal to the plain version's.
* Float-close cases (normal and laplace values, and any σ-clip, whose limit
  c·σ puts the clipped values off the 1/64 grid): the kernel's row sums add
  in another order, so its levels may differ from the plain version's by
  a few ulps; they are held within ``LEVEL_RTOL`` of the row's max |v|.
  A Lloyd iteration re-splits a row at b₀ = (b₋₁ + b₁) / 2: when the two
  b₀ differ by an ulp and a value lies between them, it changes sides and
  the means move by ~|v| / count; such rows (at most ``FLIP_SHARE`` of
  them, and at least one allowed) are held within ``FLIP_RTOL``.
  The words are exact GIVEN the levels: they equal the threshold of the
  kernel's own levels bit for bit, and a word bit may differ from the
  plain version's only at an element within that tolerance of the
  threshold.
* The kernel's own order: on every input its levels are bit-equal to
  ``kernel_order_levels``, the same additions in plain PyTorch on the CPU,
  and the warp path's levels and words to the block path's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encode
from repro_torch.core.api import make_quantizer
from repro_torch.core.comm import wire
from repro_torch.kernels import bingrad, fused_bingrad, fused_encode

LEVEL_RTOL = 1e-5
FLIP_SHARE = 1e-3
FLIP_RTOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _data(nb, d, seed, dist, masked):
    rng = np.random.default_rng(seed)
    if dist == "q64":
        v = rng.integers(-64, 65, (nb, d)) / 64
    elif dist == "laplace":
        v = rng.laplace(size=(nb, d)) * 0.2
    else:
        v = rng.standard_normal((nb, d)) * 0.3
    v = torch.from_numpy(v.astype(np.float32))
    mask = (torch.from_numpy(rng.random((nb, d)) >= 0.1) if masked
            else None)
    if nb >= 4:       # degenerate rows: constant, all masked, one-sided
        v[0] = 0.25
        v[2] = torch.abs(v[2])
        if mask is not None:
            mask[1] = False
    return v, mask


def _to(dev, *ts):
    return [None if t is None else t.to(dev) for t in ts]


def _threshold_words(v, mask, lim, levels):
    """The wire words of ``v`` thresholded at the midpoint of ``levels``."""
    return fused_encode.encode_fused_plain(v, levels, None, mask, lim,
                                           bits=1, mode="bin")


def _bits(words, d):
    return encode.unpack(words.cpu(), 1, d)


EXACT = [(d, masked, li) for d in (2048, 768, 300)
         for masked in (False, True) for li in (0, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,masked,lloyd_iters", EXACT)
def test_encode_bingrad_cuda_exact_on_q64(cuda, d, masked, lloyd_iters):
    v, mask = _data(37, d, d + lloyd_iters, "q64", masked)
    want_w, want_l = fused_bingrad.encode_bingrad_fused_plain(
        v, mask, None, lloyd_iters=lloyd_iters)
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(
        *_to(cuda, v, mask), None, lloyd_iters=lloyd_iters)
    torch.cuda.synchronize()
    assert torch.equal(got_l.cpu(), want_l)
    assert torch.equal(got_w.cpu(), want_w)


@pytest.mark.gpu
@pytest.mark.parametrize("dist", ["normal", "laplace", "q64"])
@pytest.mark.parametrize("d,masked,lloyd_iters,clip_c", [
    (2048, True, 0, None), (2048, False, 2, 2.5), (768, False, 0, None),
    (300, True, 2, 1.7)])
def test_encode_bingrad_cuda_close(cuda, dist, d, masked, lloyd_iters,
                                   clip_c):
    """Float-close cases: normal and laplace values, and any σ-clip (the
    limit, injected into both, puts the clipped values off the 1/64
    grid)."""
    v, mask = _data(64, d, d * 3 + lloyd_iters, dist, masked)
    lim = fused_encode.clip_limit(v, mask, clip_c)
    want_w, want_l = fused_bingrad.encode_bingrad_fused_plain(
        v, mask, lim, lloyd_iters=lloyd_iters)
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(
        *_to(cuda, v, mask, lim), lloyd_iters=lloyd_iters)
    torch.cuda.synchronize()
    got_w, got_l = got_w.cpu(), got_l.cpu()
    vmax = v.abs().amax(dim=1, keepdim=True)
    tol = LEVEL_RTOL * vmax
    diff = (got_l - want_l).abs()
    near = (diff <= tol).all(dim=1)
    assert int((~near).sum()) <= max(1, FLIP_SHARE * len(v))
    assert bool((diff <= FLIP_RTOL * vmax).all())
    # exact given the levels: the threshold of the kernel's own levels
    assert torch.equal(got_w, _threshold_words(v, mask, lim, got_l))
    # a bit differs from the plain version's only near the threshold
    vc = v if lim is None else torch.minimum(torch.maximum(v, -lim), lim)
    thr = 0.5 * (want_l[:, :1] + want_l[:, 1:])
    flips = (_bits(got_w, d) != _bits(want_w, d)) & near[:, None]
    assert bool(((vc - thr).abs()[flips] <= 2 * tol.expand_as(v)[flips])
                .all())
    print(f"{dist} d={d}: {int(flips.sum())} word bits differ from the "
          f"plain version, {int((got_l != want_l).sum())} level entries")


@pytest.mark.gpu
@pytest.mark.parametrize("d,masked", [(2048, True), (768, False),
                                      (100, True)])
def test_encode_bingrad_words_equal_encode_fused_bin(cuda, d, masked):
    """Cross-check: ``encode_fused`` in mode "bin", given the levels
    ``encode_bingrad_fused`` fitted, packs the same words."""
    v, mask = _data(41, d, d + 5, "normal", masked)
    v, mask = _to(cuda, v, mask)
    words, levels = fused_bingrad.encode_bingrad_fused_cuda(v, mask, None)
    again = fused_encode.encode_fused_cuda(v, levels, None, mask, None,
                                           bits=1, mode="bin")
    torch.cuda.synchronize()
    assert torch.equal(words, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dist,d,masked", [
    ("q64", 2048, True), ("q64", 300, False), ("normal", 2048, True),
    ("laplace", 4096, False)])
def test_bingrad_pass_cuda(cuda, dist, d, masked):
    """Assignment and counts exact; sums bit-equal on q64 and within
    LEVEL_RTOL of the row's |v| sum otherwise."""
    v, mask = _data(33, d, d + 11, dist, masked)
    if mask is None:
        mask = torch.ones_like(v, dtype=torch.bool)
    b0 = v.mean(dim=1, keepdim=True)
    want_i, want_p = bingrad.bingrad_pass_plain(v, b0, mask)
    got_i, got_p = bingrad.bingrad_pass_cuda(*_to(cuda, v, b0, mask))
    torch.cuda.synchronize()
    got_i, got_p = got_i.cpu(), got_p.cpu()
    assert got_i.dtype == torch.int32 and torch.equal(got_i, want_i)
    assert torch.equal(got_p[:, 1::2], want_p[:, 1::2])      # counts
    if dist == "q64":
        assert torch.equal(got_p, want_p)
    else:
        tol = LEVEL_RTOL * v.abs().sum(dim=1)
        assert bool(((got_p[:, 0::2] - want_p[:, 0::2]).abs()
                     <= tol[:, None]).all())


ORDER_DS = (1, 31, 32, 33, 300, 767, 768, 2047, 2048, 2049, 4096, 8192)
NBS = (1, 2, 131, 133, 1057)
ORDER_CASES = [(d, li, masked, clip_c)
               for d in ORDER_DS for li in (0, 1, 3)
               for masked, clip_c in ((False, None), (True, None),
                                      (False, 2.5), (True, 1.7))]


def _bits_of(t):
    return t.contiguous().view(torch.int32)


def _order_data(nb, d, seed, dist, masked):
    """``_data`` plus rows whose sums are ±0: every value -0.0; values that
    cancel exactly (a q64 row and its negation); and -0.0 at every other
    column beside values of 0.5 and more, so that the side below b0 holds
    only -0.0."""
    v, mask = _data(nb, d, seed, dist, masked)
    if nb >= 6:
        v[3] = -0.0
        q = torch.from_numpy(np.random.default_rng(seed).integers(
            -64, 65, (d + 1) // 2).astype(np.float32) / 64)
        v[4] = torch.cat([q, -q])[:d] if d % 2 == 0 else torch.cat(
            [q[:-1], -q[:-1], q[-1:] * 0])
        cols = torch.arange(d)
        v[5] = torch.where(cols % 2 == 0, -0.0,
                           0.5 + q.abs().repeat(2)[:d] / 2)
    return v, mask


def _plan_of(path, nb, d):
    """The plan of ``path`` for nb rows of d as the wrapper would take it:
    "block" at any d, "warp_async" (4-byte copies) at d <= 2048."""
    if path == "block":
        return fused_bingrad.LaunchPlan(
            "block", fused_bingrad.block_threads(d) // 32, nb, 0)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    return fused_bingrad.launch_plan(nb, d, sm, align=4)


def _encode_with(plan, v, mask, lim, lloyd_iters):
    nb, d = v.shape
    words = torch.empty((nb, encode.packed_words(d, 1)), dtype=torch.int32,
                        device=v.device)
    levels = torch.empty((nb, 2), dtype=torch.float32, device=v.device)
    fused_bingrad._launch(v, mask, lim, words, levels, lloyd_iters, plan)
    return words, levels


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(ORDER_CASES)))
def test_encode_bingrad_cuda_levels_equal_kernel_order(cuda, case):
    """Levels bit-equal (±0 included) to ``kernel_order_levels`` on the CPU,
    on normal, laplace and q64 data; words the threshold of those levels;
    at d <= 2048 the warp path the wrapper takes (bulk copies where d is a
    multiple of 16, else 4-byte copies), the 4-byte copies' path and the
    block path bit-equal on the same inputs. nb cycles through NBS (up to
    133 rows past the warp paths' widths)."""
    d, li, masked, clip_c = ORDER_CASES[case]
    nbs = NBS if d <= fused_bingrad.WARP_MAX_D else NBS[:4]
    nb = nbs[case % len(nbs)]
    for k, dist in enumerate(("normal", "laplace", "q64")):
        v, mask = _order_data(nb, d, 7 * case + k, dist, masked)
        lim = fused_encode.clip_limit(v, mask, clip_c)
        want = fused_bingrad.kernel_order_levels(v, mask, lim,
                                                 lloyd_iters=li)
        args = _to(cuda, v, mask, lim)
        got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(
            *args, lloyd_iters=li)
        torch.cuda.synchronize()
        assert torch.equal(_bits_of(got_l.cpu()), _bits_of(want)), dist
        assert torch.equal(got_w.cpu(),
                           _threshold_words(v, mask, lim, got_l.cpu()))
        if d <= fused_bingrad.WARP_MAX_D:
            for path in ("warp_async", "block"):
                w, lv = _encode_with(_plan_of(path, nb, d), *args, li)
                torch.cuda.synchronize()
                assert torch.equal(_bits_of(lv), _bits_of(got_l)), path
                assert torch.equal(w, got_w), path


@pytest.mark.gpu
@pytest.mark.parametrize("d", [768, 2047, 2048])
@pytest.mark.parametrize("mask_offset,path", [(4, "warp_async"),
                                              (1, "block")])
def test_encode_bingrad_cuda_unaligned_tensors(cuda, d, mask_offset, path):
    """Tensors that start off a 16-byte boundary cannot take bulk copies:
    values one float and mask bytes 4 bytes past one take the 4-byte
    copies, mask bytes 1 byte past one the block path; the same levels
    and words as from aligned tensors, on every row (the last row's mask
    window ends at the tensor's end)."""
    v, mask = _order_data(133, d, d, "normal", True)
    want_w, want_l = fused_bingrad.encode_bingrad_fused_cuda(
        *_to(cuda, v, mask), None)
    vbuf = torch.empty(133 * d + 1, device=cuda)
    mbuf = torch.zeros(133 * d + mask_offset, dtype=torch.bool, device=cuda)
    vo = vbuf[1:].view(133, d)
    mo = mbuf[mask_offset:].view(133, d)
    vo.copy_(v)
    mo.copy_(mask)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    align = min(16, *(p & -p for p in (vo.data_ptr(), mo.data_ptr())))
    assert fused_bingrad.launch_plan(133, d, sm, align).path == path
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(vo, mo, None)
    torch.cuda.synchronize()
    assert torch.equal(_bits_of(got_l), _bits_of(want_l))
    assert torch.equal(got_w, want_w)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [31, 768, 2048, 4096])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
def test_encode_bingrad_cuda_degenerate_rows(cuda, d, lloyd_iters):
    """Constant row: both levels the constant, every bit set. All-masked
    row: levels 0, words 0. One-sided row: both levels inside its range.
    Every value -0.0: the sums start at +0, so the levels are +0 and every
    bit is set (-0 >= +0). Exactly cancelling values: b0 = 0. -0.0 below
    b0 and nothing else: the lower level is +0. All bit-equal to
    ``kernel_order_levels``."""
    v, mask = _order_data(8, d, d + lloyd_iters, "q64", True)
    mask[0] = mask[2] = mask[3] = mask[4] = mask[5] = True
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(
        *_to(cuda, v, mask), None, lloyd_iters=lloyd_iters)
    torch.cuda.synchronize()
    got_w, got_l = got_w.cpu(), got_l.cpu()
    want = fused_bingrad.kernel_order_levels(v, mask, None,
                                             lloyd_iters=lloyd_iters)
    assert torch.equal(_bits_of(got_l), _bits_of(want))
    assert torch.equal(got_w, _threshold_words(v, mask, None, got_l))
    bits = _bits(got_w, d)
    assert got_l[0].tolist() == [0.25, 0.25] and bool(bits[0].all())
    assert got_l[1].tolist() == [0.0, 0.0] and not bool(bits[1].any())
    assert float(v[2].min()) <= float(got_l[2, 0]) <= float(got_l[2, 1]) \
        <= float(v[2].max())
    assert _bits_of(got_l[3]).tolist() == [0, 0] and bool(bits[3].all())
    if d > 1:     # the side below b0 holds only -0.0: its mean is +0
        assert int(_bits_of(got_l[5])[0]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
@pytest.mark.parametrize("d", [33, 768, 2047, 2048, 4096])
def test_encode_bingrad_cuda_nan_and_inf(cuda, d, lloyd_iters, clip_c):
    """Rows with NaN (valid and masked) and infinite values take the exact
    sweep, which adds the reference's terms v * m, v * lo and v * hi of
    every slot: levels bit-equal to ``kernel_order_levels`` (NaN where the
    reference's are NaN; a NaN level equal to a NaN level), words the
    threshold of those levels."""
    rng = np.random.default_rng(d + lloyd_iters)
    v = torch.from_numpy((rng.standard_normal((8, d)) * 0.3)
                         .astype(np.float32))
    mask = torch.from_numpy(rng.random((8, d)) >= 0.1)
    c = min(5, d - 1)
    v[0, c], mask[0, c] = float("nan"), True
    v[1, c], mask[1, c] = float("nan"), False
    v[2, c], mask[2, c] = float("inf"), True
    v[3, 0], v[3, c], mask[3, 0], mask[3, c] = (float("-inf"), float("inf"),
                                                True, True)
    v[4, c], mask[4, c] = float("-inf"), True
    lim = fused_encode.clip_limit(v, mask, clip_c)
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(
        *_to(cuda, v, mask, lim), lloyd_iters=lloyd_iters)
    torch.cuda.synchronize()
    got_w, got_l = got_w.cpu(), got_l.cpu()
    want = fused_bingrad.kernel_order_levels(v, mask, lim,
                                             lloyd_iters=lloyd_iters)
    same = (_bits_of(got_l) == _bits_of(want)) | (got_l.isnan()
                                                  & want.isnan())
    assert bool(same.all())
    assert torch.equal(got_w, _threshold_words(v, mask, lim, got_l))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [33, 768, 4096])
def test_bingrad_pass_cuda_nan_and_inf(cuda, d):
    """The pass on NaN and infinite values (valid and masked): assignment
    and counts exact, sums NaN where the plain version's are (a left-out
    NaN or infinity), else within LEVEL_RTOL of the row's finite |v| sum."""
    rng = np.random.default_rng(d)
    v = torch.from_numpy((rng.standard_normal((8, d)) * 0.3)
                         .astype(np.float32))
    mask = torch.from_numpy(rng.random((8, d)) >= 0.1)
    c = min(5, d - 1)
    v[0, c], mask[0, c] = float("nan"), True
    v[1, c], mask[1, c] = float("nan"), False
    v[2, c], mask[2, c] = float("inf"), True
    v[3, c], mask[3, c] = float("-inf"), False
    b0 = torch.full((8, 1), 0.1)
    want_i, want_p = bingrad.bingrad_pass_plain(v, b0, mask)
    got_i, got_p = bingrad.bingrad_pass_cuda(*_to(cuda, v, b0, mask))
    torch.cuda.synchronize()
    got_i, got_p = got_i.cpu(), got_p.cpu()
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_p[:, 1::2], want_p[:, 1::2])
    finite = torch.where(mask & v.isfinite(), v.abs(), 0.0).sum(1).max()
    torch.testing.assert_close(got_p, want_p, rtol=0,
                               atol=LEVEL_RTOL * float(finite),
                               equal_nan=True)
    assert bool(got_p[[0, 1, 3]][:, 0::2].isnan().all())
    assert bool(got_p[2, 0].isnan()) and float(got_p[2, 2]) == float("inf")


@pytest.mark.gpu
@pytest.mark.parametrize("nb", NBS + (16, 66_058 // 50))
def test_encode_bingrad_cuda_every_row_once(cuda, nb):
    """Each row's words and levels are its own: row r holds (r + 1) / 64 on
    its first r % 97 + 1 columns and zeros after, so a row written twice
    or by another row's warp shows, whatever the grid's walk."""
    d = 768
    r = torch.arange(nb)[:, None]
    v = torch.where(torch.arange(d)[None] <= r % 97, (r + 1) / 64, 0.0)
    got_w, got_l = fused_bingrad.encode_bingrad_fused_cuda(v.to(cuda), None,
                                                           None)
    torch.cuda.synchronize()
    want = fused_bingrad.kernel_order_levels(v, None, None)
    assert torch.equal(_bits_of(got_l.cpu()), _bits_of(want))
    assert torch.equal(got_w.cpu(), _threshold_words(v, None, None,
                                                     got_l.cpu()))


@pytest.mark.gpu
def test_bin_qdq_is_the_decode_of_the_encode_at_training_shape(cuda):
    """EF identity: bin-mode ``wire.qdq`` equals the decode of bin-mode
    ``wire.encode`` bit for bit at the training path's layout (lm-100m's
    135,285,504 values in buckets of 2048, the last one ragged)."""
    nb, d, n = 66_058, 2048, 135_285_504
    g = torch.Generator(device=cuda).manual_seed(0)
    mask = (torch.arange(nb * d, device=cuda) < n).reshape(nb, d)
    v = torch.where(mask, torch.randn((nb, d), generator=g, device=cuda)
                    * 1e-3, 0.0)
    for clip_c, lloyd in ((None, 0), (2.5, 2)):
        qz = make_quantizer("bingrad-b", bucket_size=d, clip_c=clip_c,
                            lloyd_iters=lloyd)
        words, levels = wire.encode(qz, v, mask, None)
        want = wire.decode_each(qz, words[None], levels[None], d)[0]
        got = wire.qdq(qz, v, mask, None)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        del words, levels, want, got


@pytest.mark.gpu
def test_full_width_bingrad_step_goes_through_the_kernels(cuda,
                                                          monkeypatch):
    """One lm-100m BinGrad-b step with EF through the launcher on a world of
    one (NCCL): finite loss, the reference's wire bytes, no rounding stream,
    and the kernels launched as Algorithm 2 says (phase 1, phase 2 and the
    EF levels each one fused BinGrad encode)."""
    from repro_torch.core import prng
    from repro_torch.kernels import fused_decode
    from repro_torch.launch import train as launcher

    seen = []
    real = prng.bits

    def spy(k, shape):
        seen.append(int(np.prod(shape)))
        return real(k, shape)

    monkeypatch.setattr(prng, "bits", spy)
    counters = [fused_bingrad.encode_bingrad_fused_cuda,
                fused_encode.encode_fused_cuda, fused_encode.qdq_fused_cuda,
                fused_decode.decode_fused_mean_cuda,
                fused_decode.decode_fused_each_cuda]
    before = [fn.launches for fn in counters]
    r = launcher.train(["--arch", "lm-100m", "--steps", "1", "--batch", "8",
                        "--seq", "128", "--quant", "bingrad-b",
                        "--error-feedback", "--log-every", "1"])
    launches = [fn.launches - b for fn, b in zip(counters, before)]
    assert launches == [3, 0, 1, 1, 1]
    assert np.isfinite(r["history"][0]["loss"])
    assert r["wire_bytes_per_worker"] == 34_878_624
    assert r["replicas_in_sync"]
    # only the token stream draws (batch x (seq + 1)); no rounding stream
    assert seen and max(seen) <= 8 * 129


def test_bingrad_cuda_wrappers_reject_cpu_tensors():
    v, mask = _data(4, 64, 0, "normal", True)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fused_bingrad.encode_bingrad_fused_cuda(v, mask, None)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        bingrad.bingrad_pass_cuda(v, v.mean(1, keepdim=True), mask)


def test_bingrad_wrappers_check_shapes():
    v, mask = _data(4, 64, 0, "normal", True)
    with pytest.raises(ValueError, match="b0 must be"):
        bingrad.bingrad_pass_plain(v, v.mean(1), mask)
    with pytest.raises(ValueError, match="lloyd_iters"):
        fused_bingrad.encode_bingrad_fused_plain(v, mask, None,
                                                 lloyd_iters=-1)
    with pytest.raises(ValueError, match="mask must be"):
        fused_bingrad.encode_bingrad_fused_plain(v, mask[:, :3], None)


@pytest.mark.parametrize("scheme", ["bingrad-b", "signsgd"])
def test_engine_takes_the_card_unless_told(scheme):
    """The engine runs on the card by default and raises without one;
    ``device="cpu"`` runs the plain versions."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import Engine, ServeConfig

    model = LM(get_smoke_config("lm-100m"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cfg = ServeConfig(kv_quant=scheme, page_size=4, max_batch=2,
                      max_pages_per_seq=4, prefill_chunk=4)
    assert Engine(model, params, cfg, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert Engine(model, params, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(model, params, cfg)


@pytest.mark.parametrize("module,args", [
    ("serve", ["--smoke", "--kv-quant", "bingrad-b", "--batch", "1",
               "--prompt-len", "4", "--gen", "2", "--max-len", "32"]),
    ("train", ["--smoke", "--quant", "bingrad-b", "--steps", "1",
               "--batch", "1", "--seq", "8"])])
def test_launchers_raise_without_a_card(module, args):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    import importlib
    launcher = importlib.import_module(f"repro_torch.launch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(launcher, module)(args)
