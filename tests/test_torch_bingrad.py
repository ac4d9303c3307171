"""BinGrad's kernels' plain versions and the wire format of every scheme,
against the JAX reference.

* ``encode_bingrad_fused_plain`` against the reference's Pallas kernel
  (interpret mode, as its own tests run it) and its jnp oracle
  ``encode_bingrad_fused_ref``; ``bingrad_pass_plain`` against the Pallas
  ``bingrad_pass``.
* ``wire.encode`` / ``wire.qdq`` for every registered scheme against the
  reference's, same rounding bits (drawn from the same key).
* Byte accounting at full size (lm-100m) equals the reference exactly.

Tolerances, with their reasons: on multiples of 1/64 in [-1, 1] (d <=
2048) every partial sum is exact in float32 in any order, so levels,
words, sums and counts are bit-equal. Elsewhere (normal / laplace values,
or any σ-clip, whose limit c·σ puts the clipped values off that grid)
BinGrad-b's levels are row sums over counts and float-close: within
``RTOL`` of the row's max |v|. Its words are exact given the levels (the
threshold of the port's own levels), and a word bit may differ from the
reference's only at an element within that tolerance of the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import comm as jcomm
from repro.core.api import make_quantizer as jmake_quantizer
from repro.core.comm import wire as jwire
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import bingrad as jbingrad
from repro.kernels import fused_bingrad as jfused_bingrad
from repro.kernels import fused_encode as jfused_encode
from repro.kernels import ref as jref
from repro.models.model import LM as JLM
from repro.serve.kv_cache import KVQuantSpec as JKVQuantSpec
from repro.serve.kv_cache import token_bytes_ratio as jtoken_bytes_ratio
from repro_torch.configs.base import get_config
from repro_torch.core import encode, prng
from repro_torch.core.api import all_methods, make_quantizer
from repro_torch.core.comm import exchange, wire
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizers import Quantizer
from repro_torch.kernels import bingrad, fused_bingrad, fused_encode, ops, ref
from repro_torch.models import LM
from repro_torch.serve.kv_cache import KVQuantSpec, token_bytes_ratio
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-5
SCHEMES = [n for n in all_methods() if n != "fp"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(t):
    return t.numpy().view(np.uint32)


def _data(nb, d, seed, dist, masked=True):
    rng = np.random.default_rng(seed)
    if dist == "q64":
        v = rng.integers(-64, 65, (nb, d)) / 64
    elif dist == "laplace":
        v = rng.laplace(size=(nb, d)) * 0.2
    else:
        v = rng.standard_normal((nb, d)) * 0.3
    v = v.astype(np.float32)
    mask = (rng.random((nb, d)) >= 0.1) if masked else np.ones((nb, d), bool)
    v[0] = 0.25                               # a constant row
    v[2] = np.abs(v[2])                       # a one-sided row
    if masked:
        mask[1] = False                       # an all-masked row
        mask[3, d // 3:] = False              # a ragged tail
    return v, mask


def _clip(v, lim):
    return v if lim is None else np.minimum(np.maximum(v, -lim), lim)


def _check_bin(tw, tl, jw, jl, v, mask, lim, exact):
    """The port's (words, levels) against the reference's."""
    tw, tl, jw, jl = _words(tw), tl.numpy(), np.asarray(jw), np.asarray(jl)
    if exact:
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tw, jw)
        return 0
    tol = RTOL * np.abs(np.where(mask, v, 0)).max(axis=1, keepdims=True)
    assert np.all(np.abs(tl - jl) <= tol)
    d = v.shape[1]
    # exact given the levels: the threshold of the port's own levels
    vc = _clip(v, lim)
    own = encode.pack(_t(np.where(mask, vc >= 0.5 * (tl[:, :1] + tl[:, 1:]),
                                  0)), 1)
    np.testing.assert_array_equal(tw, _words(own))
    bits = lambda w: encode.unpack(_t(w.view(np.int32)), 1, d).numpy()
    flips = bits(tw) != bits(jw)
    near = np.abs(vc - 0.5 * (jl[:, :1] + jl[:, 1:])) <= 2 * tol
    assert np.all(near[flips])
    return int(flips.sum())


BIN_CASES = [(d, masked, li, clip) for d in (2048, 768, 300)
             for masked in (True, False) for li in (0, 2)
             for clip in (None, 2.5)]


@pytest.mark.parametrize("dist", ["q64", "normal"])
@pytest.mark.parametrize("d,masked,lloyd_iters,clip_c", BIN_CASES)
def test_encode_bingrad_plain_matches_pallas(d, masked, lloyd_iters, clip_c,
                                             dist):
    """Bit-equal on multiples of 1/64 without a clip; otherwise levels
    within RTOL, words the threshold of the port's own levels (the
    reference's clip limit injected), flips only at the threshold."""
    v, mask = _data(12, d, d + lloyd_iters, dist, masked)
    jw, jl = jfused_bingrad.encode_bingrad_fused(
        jnp.asarray(v), jnp.asarray(mask), clip_c=clip_c,
        lloyd_iters=lloyd_iters, interpret=True)
    jlim = jfused_encode.clip_limit(jnp.asarray(v), jnp.asarray(mask), clip_c)
    lim = None if jlim is None else np.asarray(jlim)
    tw, tl = fused_bingrad.encode_bingrad_fused_plain(
        _t(v), _t(mask) if masked else None,
        None if lim is None else _t(lim), lloyd_iters=lloyd_iters)
    n = _check_bin(tw, tl, jw, jl, v, mask, lim,
                   exact=dist == "q64" and clip_c is None)
    print(f"d={d} masked={masked} lloyd={lloyd_iters} clip={clip_c} "
          f"{dist}: {n} word bits differ from the reference's")


@pytest.mark.parametrize("dist", ["q64", "laplace"])
@pytest.mark.parametrize("clip_c", [None, 1.7])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
def test_encode_bingrad_oracle_and_dispatch(lloyd_iters, clip_c, dist):
    """The port's oracle (separate sweeps) and the CPU dispatch (the port's
    own clip limit) against the reference's jnp oracle."""
    v, mask = _data(16, 768, 7 + lloyd_iters, dist)
    jw, jl = jref.encode_bingrad_fused_ref(
        jnp.asarray(v), jnp.asarray(mask), clip_c=clip_c,
        lloyd_iters=lloyd_iters)
    exact = dist == "q64" and clip_c is None
    lim = fused_encode.clip_limit(_t(v), _t(mask), clip_c)
    lim_np = None if lim is None else lim.numpy()
    for tw, tl in (ref.encode_bingrad_fused_ref(
                       _t(v), _t(mask), clip_c=clip_c,
                       lloyd_iters=lloyd_iters),
                   ops.encode_bingrad(_t(v), _t(mask), clip_c=clip_c,
                                      lloyd_iters=lloyd_iters)):
        _check_bin(tw, tl, jw, jl, v, mask, lim_np, exact)


def test_encode_bingrad_mask_none_means_all_valid():
    v, _ = _data(6, 300, 1, "normal", masked=False)
    ones = torch.ones(v.shape, dtype=torch.bool)
    a = fused_bingrad.encode_bingrad_fused_plain(_t(v), None, None)
    b = fused_bingrad.encode_bingrad_fused_plain(_t(v), ones, None)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (6, encode.packed_words(300, 1))


def test_encode_bingrad_degenerate_rows():
    """Constant row: every value is >= b₀, so the lower side is empty and
    collapses to the upper mean: both levels the constant, every bit set.
    All-masked row: levels 0, words 0. All-positive row: both levels
    inside its range."""
    v = np.zeros((3, 64), np.float32)
    v[0] = 0.25
    v[2] = np.linspace(0.1, 0.9, 64)
    mask = np.ones_like(v, bool)
    mask[1] = False
    w, lv = fused_bingrad.encode_bingrad_fused_plain(_t(v), _t(mask), None)
    np.testing.assert_array_equal(lv[0].numpy(), [0.25, 0.25])
    assert (_words(w)[0] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(lv[1].numpy(), [0.0, 0.0])
    assert (_words(w)[1] == 0).all()
    assert 0.1 <= float(lv[2, 0]) < float(lv[2, 1]) <= 0.9
    jw, jl = jfused_bingrad.encode_bingrad_fused(
        jnp.asarray(v), jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(_words(w)[:2], np.asarray(jw)[:2])
    np.testing.assert_array_equal(lv.numpy()[:2], np.asarray(jl)[:2])


# ---------------------------------------------------------------------------
# the CUDA kernel's order of additions and its launch plan
# ---------------------------------------------------------------------------

ORDER_DS = (1, 31, 33, 300, 768, 2048)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
@pytest.mark.parametrize("d", ORDER_DS)
def test_kernel_order_levels_exact_on_q64(d, lloyd_iters, masked):
    """On multiples of 1/64 every order gives the same sums: the kernel's
    order is bit-equal to the plain version and to the reference's Pallas
    kernel (interpret mode)."""
    v, mask = _data(12, d, 3 * d + lloyd_iters, "q64", masked)
    m = _t(mask) if masked else None
    got = fused_bingrad.kernel_order_levels(_t(v), m, None,
                                            lloyd_iters=lloyd_iters)
    _, plain = fused_bingrad.encode_bingrad_fused_plain(
        _t(v), m, None, lloyd_iters=lloyd_iters)
    _, jl = jfused_bingrad.encode_bingrad_fused(
        jnp.asarray(v), jnp.asarray(mask), lloyd_iters=lloyd_iters,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl))


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
@pytest.mark.parametrize("d", ORDER_DS)
@pytest.mark.parametrize("dist", ["normal", "laplace"])
def test_kernel_order_levels_close(dist, d, lloyd_iters, masked, clip_c):
    """Elsewhere the kernel's order is float-close to the plain version's:
    within RTOL of the row's max |v| (the clip limit injected into both)."""
    v, mask = _data(12, d, 5 * d + lloyd_iters, dist, masked)
    m = _t(mask) if masked else None
    lim = fused_encode.clip_limit(_t(v), m, clip_c)
    got = fused_bingrad.kernel_order_levels(_t(v), m, lim,
                                            lloyd_iters=lloyd_iters)
    _, plain = fused_bingrad.encode_bingrad_fused_plain(
        _t(v), m, lim, lloyd_iters=lloyd_iters)
    tol = RTOL * np.abs(np.where(mask, v, 0)).max(axis=1, keepdims=True)
    assert np.all(np.abs(got.numpy() - plain.numpy()) <= tol)


def _nan_inf_rows(d, seed):
    """Rows with a NaN in a valid slot, a NaN in a masked slot, +inf, both
    infinities, -inf, and ordinary rows after them."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((8, d)) * 0.3).astype(np.float32)
    mask = rng.random((8, d)) >= 0.1
    c = min(5, d - 1)
    v[0, c], mask[0, c] = np.nan, True
    v[1, c], mask[1, c] = np.nan, False
    v[2, c], mask[2, c] = np.inf, True
    v[3, 0], v[3, c], mask[3, [0, c]] = -np.inf, np.inf, True
    v[4, c], mask[4, c] = -np.inf, True
    return v, mask


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
@pytest.mark.parametrize("d", [1, 33, 768, 2048])
def test_kernel_order_levels_nan_and_inf(d, lloyd_iters, clip_c):
    """NaN and infinite values give the reference's levels in the kernel's
    order too: its sums take v * m and v * lo, so a NaN or infinity in a
    slot left out of a sum (masked, or on the other side of b0) makes that
    sum NaN; the plain version, and the reference's Pallas kernel in
    interpret mode, agree (NaN where NaN, the rest within RTOL)."""
    v, mask = _nan_inf_rows(d, d + lloyd_iters)
    lim = fused_encode.clip_limit(_t(v), _t(mask), clip_c)
    got = fused_bingrad.kernel_order_levels(_t(v), _t(mask), lim,
                                            lloyd_iters=lloyd_iters)
    _, plain = fused_bingrad.encode_bingrad_fused_plain(
        _t(v), _t(mask), lim, lloyd_iters=lloyd_iters)
    _, jl = jfused_bingrad.encode_bingrad_fused(
        jnp.asarray(v), jnp.asarray(mask), clip_c=clip_c,
        lloyd_iters=lloyd_iters, interpret=True)
    finite = np.where(mask & np.isfinite(v), np.abs(v), 0).max()
    for want in (plain, _t(jl)):
        torch.testing.assert_close(got, want, rtol=0, atol=RTOL * finite,
                                   equal_nan=True)
    assert bool(got[0].isnan().all() and got[1].isnan().all())


@pytest.mark.parametrize("d", [33, 768])
def test_bingrad_pass_plain_nan_and_inf(d):
    """The pass on NaN and infinite values: the reference's sums v * lo and
    v * hi are NaN when a left-out slot holds one; the assignment and the
    counts are exact."""
    v, mask = _nan_inf_rows(d, d)
    b0 = np.full((8, 1), 0.1, np.float32)
    ji, jp = jbingrad.bingrad_pass(jnp.asarray(v), jnp.asarray(b0),
                                   jnp.asarray(mask), interpret=True)
    ti, tp = bingrad.bingrad_pass_plain(_t(v), _t(b0), _t(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy()[:, 1::2], np.asarray(jp)[:, 1::2])
    finite = np.where(mask & np.isfinite(v), np.abs(v), 0).sum(axis=1).max()
    torch.testing.assert_close(tp, _t(np.asarray(jp)), rtol=0,
                               atol=RTOL * finite, equal_nan=True)
    assert bool(tp[:2, 0::2].isnan().all())


PLAN_NBS = (1, 2, 16, 131, 133, 1057, 66_058)


@pytest.mark.parametrize("d,path", [(1, "warp_async"), (767, "warp_async"),
                                    (768, "warp_bulk"), (2047, "warp_async"),
                                    (2048, "warp_bulk"), (2049, "block"),
                                    (8192, "block")])
@pytest.mark.parametrize("nb", PLAN_NBS)
def test_launch_plan_walks_every_row_once(nb, d, path):
    plan = fused_bingrad.launch_plan(nb, d, 132)
    assert plan.path == path
    rows = fused_bingrad.walked_rows(plan, nb)
    assert torch.equal(torch.sort(rows).values, torch.arange(nb))
    if path == "block":
        assert plan.grid == nb
        assert plan.warps * 32 == fused_bingrad.block_threads(d)
        return
    assert 1 <= plan.warps <= fused_bingrad.WARP_MAX_WARPS
    if nb <= 132:           # few rows: a block and an SM each
        assert plan.warps == 1 and plan.grid == nb
    # the persistent grid fits the SMs at once; a stage holds a row
    stage = plan.shared_bytes // plan.warps
    resident = min(fused_bingrad.SM_SHARED_BYTES // (plan.shared_bytes
                                                     + 1024),
                   fused_bingrad.WARPS_PER_SM // plan.warps)
    assert plan.grid <= 132 * resident
    assert stage == 40 * fused_bingrad.block_threads(d) + 128 >= 5 * d + 128


def test_launch_plan_takes_every_width():
    """Every d in 1..MAX_D gets a path within the card's limits: a warp
    path up to WARP_MAX_D (bulk copies where d is a multiple of 16 and the
    tensors start on 16 bytes, 4-byte copies where they start on 4), the
    block path (nt <= 1024 threads) after and for mask bytes off a 4-byte
    boundary; no block needs more shared memory than the default 48 KB."""
    for d in range(1, fused_bingrad.MAX_D + 1):
        for nb in (16, 1057, 66_058):
            for align in (16, 4, 1):
                plan = fused_bingrad.launch_plan(nb, d, 132, align)
                if d > fused_bingrad.WARP_MAX_D or align < 4:
                    want = "block"
                elif align == 16 and d % 16 == 0:
                    want = "warp_bulk"
                else:
                    want = "warp_async"
                assert plan.path == want
                assert plan.warps * 32 <= 1024 and plan.grid >= 1
                assert 0 <= plan.shared_bytes <= \
                    fused_bingrad.SHARED_BYTES_DEFAULT
    for d in (0, fused_bingrad.MAX_D + 1):
        with pytest.raises(ValueError, match="no launch"):
            fused_bingrad.launch_plan(16, d, 132)


@pytest.mark.parametrize("dist,d,masked", [("q64", 2048, True),
                                           ("q64", 300, False),
                                           ("normal", 768, True),
                                           ("laplace", 2048, False)])
def test_bingrad_pass_plain_matches_pallas(dist, d, masked):
    """Assignment and counts exact; sums bit-equal on q64, else within
    RTOL of the row's Σ|v|."""
    v, mask = _data(12, d, d + 3, dist, masked)
    b0 = v.mean(axis=1, keepdims=True).astype(np.float32)
    ji, jp = jbingrad.bingrad_pass(jnp.asarray(v), jnp.asarray(b0),
                                   jnp.asarray(mask), interpret=True)
    ti, tp = bingrad.bingrad_pass_plain(_t(v), _t(b0), _t(mask))
    ji, jp = np.asarray(ji), np.asarray(jp)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tp.numpy()[:, 1::2], jp[:, 1::2])
    if dist == "q64":
        np.testing.assert_array_equal(tp.numpy(), jp)
    else:
        tol = RTOL * np.abs(np.where(mask, v, 0)).sum(axis=1)
        assert np.all(np.abs(tp.numpy()[:, 0::2] - jp[:, 0::2])
                      <= tol[:, None])
    wi, wp = ops.bingrad_pass(_t(v), _t(b0), _t(mask))
    assert torch.equal(wi, ti) and torch.equal(wp, tp)


# ---------------------------------------------------------------------------
# wire.encode / wire.qdq for every scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCHEMES)
def test_wire_encode_every_scheme_bit_equal_on_q64(name):
    """Same key, same rounding bits: words and levels bit-equal (every fit
    is exact on multiples of 1/64)."""
    v, mask = _data(16, 512, 21, "q64")
    jq, tq = (jmake_quantizer(name, bucket_size=512),
              make_quantizer(name, bucket_size=512))
    jw, jl = jwire.encode(jq, jnp.asarray(v), jnp.asarray(mask),
                          jax.random.key(3))
    tw, tl = wire.encode(tq, _t(v), _t(mask), prng.key(3))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(_words(tw), np.asarray(jw))


@pytest.mark.parametrize("name", SCHEMES)
def test_wire_qdq_every_scheme_bit_equal_on_q64(name):
    v, mask = _data(16, 512, 22, "q64")
    jq, tq = (jmake_quantizer(name, bucket_size=512),
              make_quantizer(name, bucket_size=512))
    want = np.asarray(jwire.qdq(jq, jnp.asarray(v), jnp.asarray(mask),
                                jax.random.key(4)))
    got = wire.qdq(tq, _t(v), _t(mask), prng.key(4)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clip_c", [None, 2.5])
@pytest.mark.parametrize("lloyd_iters", [0, 2])
def test_bin_qdq_is_the_decode_of_the_encode(lloyd_iters, clip_c):
    """Error feedback's residual is taken against what went on the wire:
    bin-mode qdq equals the decode of bin-mode encode, bit for bit."""
    v, mask = _data(24, 2048, 5, "normal")
    qz = make_quantizer("bingrad-b", bucket_size=2048, clip_c=clip_c,
                        lloyd_iters=lloyd_iters)
    words, levels = wire.encode(qz, _t(v), _t(mask), None)
    want = wire.decode_each(qz, words[None], levels[None], 2048)[0]
    got = wire.qdq(qz, _t(v), _t(mask), None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["bingrad-b", "signsgd", "terngrad",
                                  "bingrad-pb", "qsgd-5"])
def test_wire_encode_close_on_normal(name):
    """Float-close fits: the rows whose levels agree have bit-equal words;
    the levels agree within RTOL."""
    v, mask = _data(32, 768, 23, "normal")
    jq, tq = (jmake_quantizer(name, bucket_size=768),
              make_quantizer(name, bucket_size=768))
    jw, jl = jwire.encode(jq, jnp.asarray(v), jnp.asarray(mask),
                          jax.random.key(5))
    tw, tl = wire.encode(tq, _t(v), _t(mask), prng.key(5))
    jw, jl, tl = np.asarray(jw), np.asarray(jl), tl.numpy()
    tol = RTOL * np.abs(np.where(mask, v, 0)).max(axis=1, keepdims=True)
    if name == "bingrad-pb":     # argmin may move a row to a neighbour
        assert ((tl != jl).any(axis=1)).mean() <= 0.05
    else:
        assert np.all(np.abs(tl - jl) <= tol)
    same = (tl == jl).all(axis=1)
    np.testing.assert_array_equal(_words(tw)[same], jw[same])


def test_scheme_without_a_fused_mode_raises():
    """A scheme with no fused mode takes the multi-pass encode and qdq,
    which fit first: for a method with no fit both raise there, as the
    reference's do (``test_torch_multipass.py`` holds the fallback of
    every real scheme against the reference)."""
    from repro.core.quantizers import Quantizer as JQuantizer
    v, mask = _data(4, 64, 0, "normal")
    for fn, jfn in ((wire.encode, jwire.encode), (wire.qdq, jwire.qdq)):
        with pytest.raises(ValueError, match="unknown method"):
            fn(Quantizer(method="custom"), _t(v), _t(mask), None)
        with pytest.raises(ValueError, match="unknown method"):
            jfn(JQuantizer(method="custom"), jnp.asarray(v),
                jnp.asarray(mask), None)


# ---------------------------------------------------------------------------
# byte accounting at full size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm100m():
    jmodel = JLM(jget_config("lm-100m"))
    jap = jax.eval_shape(jmodel.init, jax.random.key(0))
    model = LM(get_config("lm-100m"))
    return jmodel, jap, model, model.abstract_params()


BIN_WIRE = {1: 34_878_624}


@pytest.mark.parametrize("policy", ["bingrad-b", "signsgd", "terngrad",
                                    "qsgd-5",
                                    "norm|bias=fp,embed=bingrad-b,"
                                    "default=orq-9"])
def test_lm100m_wire_bytes_equal_reference(lm100m, policy):
    jmodel, jap, model, ap = lm100m
    pex = exchange.PartitionedExchange.build(
        QuantPolicy.parse(policy, bucket_size=2048), ap,
        paths=model.param_paths(ap))
    jpex = jcomm.PartitionedExchange.build(
        JPolicy.parse(policy, bucket_size=2048), jap, ("data",),
        paths=jmodel.param_paths(jap))
    assert pex.collective_launches() == jpex.collective_launches()
    for L in (1, 4, 8):
        assert pex.wire_bytes_per_worker(L) == jpex.wire_bytes_per_worker(L)
    if policy == "bingrad-b":
        # 2 phases x 66,058 buckets x (64 words + 2 levels) x 4 bytes
        assert pex.wire_bytes_per_worker(1) == BIN_WIRE[1] == \
            2 * 66_058 * (64 + 2) * 4


@pytest.mark.parametrize("scheme", SCHEMES + ["bf16"])
def test_kv_token_bytes_every_scheme(scheme):
    mc = get_config("lm-100m")
    args = (scheme, mc.num_kv_heads, mc.resolved_head_dim)
    t, j = KVQuantSpec(*args), JKVQuantSpec(*args)
    assert t.token_bytes() == j.token_bytes()
    assert token_bytes_ratio(t) == jtoken_bytes_ratio(j)
    want = {"bingrad-b": (208, 0.0677), "orq-5": (656, 0.2135),
            "orq-9": (840, 0.2734)}.get(scheme)
    if want:
        assert (t.token_bytes(), round(token_bytes_ratio(t), 4)) == want
