"""Every level solver of the port against the JAX reference's
``core/levels.py``, and ``Quantizer.fit`` / ``QuantConfig`` for every
scheme of the registry.

Tolerances, with their reasons:

* Values that are multiples of 1/64 in [-1, 1] (d <= 2048) make every row
  sum and prefix sum exact in float32 in any order: every solver is
  bit-equal there, masked and ragged.
* TernGrad, QSGD-ℓ∞, Linear-s and min/max take a max, a sort or a
  quantile index and no sum: bit-equal on any data.
* BinGrad-b, SignSGD and QSGD-ℓ2 divide row sums: on normal and laplace
  data within ``RTOL`` of the row's max |v| (measured: a few float32 ulps).
* BinGrad-pb's argmin over prefix sums may pick a neighbouring data value
  when a prefix sum rounds differently: at most ``PB_ROW_SHARE`` of the
  rows may differ, and there the chosen value's Eq. (15) objective
  (evaluated in float64) is within ``RTOL`` of the row's Σ|v| of the
  reference's choice.
* ORQ's levels are float-close as in ``test_torch_quant.py`` (at most 1%
  of the entries move to a neighbouring value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import levels as jlevels
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import make_quantizer as jmake_quantizer
from repro_torch.core import levels
from repro_torch.core.api import QuantConfig, all_methods, make_quantizer
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

RTOL = 1e-5
PB_ROW_SHARE = 0.05


def _data(nb, d, seed, dist, frac_masked=0.1):
    rng = np.random.default_rng(seed)
    if dist == "q64":
        v = rng.integers(-64, 65, (nb, d)) / 64
    elif dist == "laplace":
        v = rng.laplace(size=(nb, d)) * 0.2
    else:
        v = rng.standard_normal((nb, d)) * 0.3
    v = v.astype(np.float32)
    mask = rng.random((nb, d)) >= frac_masked
    mask[0] = False                      # an all-masked bucket
    mask[1] = False
    mask[1, :3] = True                   # three valid slots
    v[2] = 0.25                          # a constant bucket
    v[3] = np.abs(v[3])                  # a one-sided bucket
    mask[4, d // 2:] = False             # a ragged tail
    return v, mask


def _both(v, mask):
    return ((jnp.asarray(v), jnp.asarray(mask)),
            (torch.from_numpy(v), torch.from_numpy(mask)))


SOLVERS = {  # name -> (reference call, port call)
    "bingrad_b": (lambda v, m: jlevels.bingrad_b_levels(v, m),
                  lambda v, m: levels.bingrad_b_levels(v, m)),
    "bingrad_b_lloyd2": (
        lambda v, m: jlevels.bingrad_b_levels(v, m, lloyd_iters=2),
        lambda v, m: levels.bingrad_b_levels(v, m, lloyd_iters=2)),
    "bingrad_pb": (jlevels.bingrad_pb_b1, levels.bingrad_pb_b1),
    "terngrad": (jlevels.terngrad_levels, levels.terngrad_levels),
    "qsgd5": (lambda v, m: jlevels.qsgd_levels(v, m, 5),
              lambda v, m: levels.qsgd_levels(v, m, 5)),
    "qsgd9_l2": (lambda v, m: jlevels.qsgd_levels(v, m, 9, norm="l2"),
                 lambda v, m: levels.qsgd_levels(v, m, 9, norm="l2")),
    "linear5": (lambda v, m: jlevels.linear_levels(v, m, 5),
                lambda v, m: levels.linear_levels(v, m, 5)),
    "linear9": (lambda v, m: jlevels.linear_levels(v, m, 9),
                lambda v, m: levels.linear_levels(v, m, 9)),
    "signsgd": (jlevels.signsgd_scale, levels.signsgd_scale),
    "minmax": (jlevels.minmax_levels, levels.minmax_levels),
    "orq9_refine2": (
        lambda v, m: jlevels.orq_levels(v, m, 3, refine_iters=2),
        lambda v, m: levels.orq_levels(v, m, 3, refine_iters=2)),
}
NO_SUMS = ("terngrad", "qsgd5", "linear5", "linear9", "minmax")


@pytest.mark.parametrize("d", [2048, 300])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solver_bit_equal_on_q64(name, d):
    v, mask = _data(32, d, d + len(name), "q64")
    (jv, jm), (tv, tm) = _both(v, mask)
    jf, tf = SOLVERS[name]
    want, got = np.asarray(jf(jv, jm)), tf(tv, tm).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pb_objective(v, mask, b1):
    """Eq. (15)'s |b₁·#(v > 0) − Σ_{v >= b₁} v| per row, in float64."""
    out = []
    for row, m, b in zip(v.astype(np.float64), mask, b1.astype(np.float64)):
        x = row[m]
        out.append(abs(b * (x > 0).sum() - x[x >= b].sum()))
    return np.asarray(out)


@pytest.mark.parametrize("dist", ["normal", "laplace"])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_solver_close_on_normal_and_laplace(name, dist):
    v, mask = _data(48, 768, len(name) * 7 + len(dist), dist)
    (jv, jm), (tv, tm) = _both(v, mask)
    jf, tf = SOLVERS[name]
    want, got = np.asarray(jf(jv, jm)), tf(tv, tm).numpy()
    assert got.shape == want.shape
    scale = np.abs(np.where(mask, v, 0)).max(axis=1)
    if name in NO_SUMS:
        np.testing.assert_array_equal(got, want)
    elif name == "orq9_refine2":
        flips = int((got != want).sum())
        assert flips <= 0.01 * want.size
        assert np.all(np.diff(got, axis=1) >= 0)
    elif name == "bingrad_pb":
        rows = got != want
        print(f"bingrad_pb {dist}: {int(rows.sum())} of {len(rows)} rows "
              f"chose another value")
        assert rows.mean() <= PB_ROW_SHARE
        l1 = np.abs(np.where(mask, v, 0)).sum(axis=1)
        fo, fw = _pb_objective(v, mask, got), _pb_objective(v, mask, want)
        assert np.all(np.abs(fo - fw)[rows] <= RTOL * l1[rows])
    else:
        err = np.abs(got - want).max(axis=-1) if got.ndim > 1 else \
            np.abs(got - want)
        if name == "qsgd9_l2":
            scale = np.sqrt((np.where(mask, v, 0) ** 2).sum(axis=1))
        print(f"{name} {dist}: {int((got != want).sum())} entries differ, "
              f"max {float(err.max())}")
        assert np.all(err <= RTOL * np.maximum(scale, 1e-30))


@pytest.mark.parametrize("dist", ["normal", "laplace"])
def test_orq_optimality_residual_small(dist):
    """Theorem 1 holds at the port's own ORQ output as it does at the
    reference's: the Eq. (8) residual is ~0 (the reference's own test
    bound, 0.08), and the port's residual function gives the reference's
    on the same levels."""
    rng = np.random.default_rng(5)
    v = (rng.laplace(size=(8, 2048)) * 0.02 if dist == "laplace"
         else rng.standard_normal((8, 2048)) * 0.02).astype(np.float32)
    mask = np.ones_like(v, dtype=bool)
    (jv, jm), (tv, tm) = _both(v, mask)
    for refine in (0, 2):
        lv = levels.orq_levels(tv, tm, 3, refine_iters=refine)
        res = levels.optimality_residual(tv, tm, lv).numpy()
        assert res.shape == (8, 7)
        assert np.abs(res).max() < 0.08
        want = np.asarray(jlevels.optimality_residual(
            jv, jm, jnp.asarray(lv.numpy())))
        np.testing.assert_allclose(res, want, rtol=0, atol=1e-5)


def test_refine_does_not_raise_the_residual():
    rng = np.random.default_rng(6)
    v = (rng.laplace(size=(16, 2048)) * 0.02).astype(np.float32)
    tv, tm = torch.from_numpy(v), torch.ones(v.shape, dtype=torch.bool)
    r0 = levels.optimality_residual(tv, tm, levels.orq_levels(tv, tm, 3))
    r3 = levels.optimality_residual(
        tv, tm, levels.orq_levels(tv, tm, 3, refine_iters=3))
    assert float(r3.abs().mean()) <= float(r0.abs().mean()) * 1.0001


@pytest.mark.parametrize("name", [n for n in all_methods() if n != "fp"])
@pytest.mark.parametrize("clip_c", [None, 2.5])
def test_quantizer_fit_every_scheme(name, clip_c):
    """``make_quantizer(name).fit`` for every registered scheme: ascending
    tables of ``s`` levels, bit-equal to the reference on multiples of
    1/64. With ``clip_c`` the clipped values sit at ±c·σ, off the 1/64
    grid (σ divides row sums), so the fits that sum are float-close:
    at least 99% of the entries within RTOL of the row's max |v|."""
    v, mask = _data(24, 512, 3, "q64")
    (jv, jm), (tv, tm) = _both(v, mask)
    tq = make_quantizer(name, bucket_size=512, clip_c=clip_c)
    jq = jmake_quantizer(name, bucket_size=512, clip_c=clip_c)
    got, want = tq.fit(tv, tm).numpy(), np.asarray(jq.fit(jv, jm))
    assert got.shape == (24, tq.s)
    assert np.all(np.diff(got, axis=1) >= 0)
    if clip_c is None:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(np.where(mask, v, 0)).max(axis=1, keepdims=True)
        close = np.abs(got - want) <= RTOL * scale
        print(f"{name} clip {clip_c}: {int((~close).sum())} of {got.size} "
              f"entries outside RTOL")
        assert close.mean() >= 0.99
    assert tq.unbiased == jq.unbiased


@pytest.mark.parametrize("kw", [dict(refine_iters=2), dict(lloyd_iters=3),
                                dict(refine_iters=1, lloyd_iters=1)])
def test_quant_config_passes_the_knobs(kw):
    for name in ("orq-9", "bingrad-b"):
        tq = QuantConfig(name=name, bucket_size=512, **kw).to_quantizer()
        jq = JQuantConfig(name=name, bucket_size=512, **kw).to_quantizer()
        assert (tq.refine_iters, tq.lloyd_iters) == \
            (jq.refine_iters, jq.lloyd_iters)
        v, mask = _data(8, 512, 9, "q64")
        (jv, jm), (tv, tm) = _both(v, mask)
        np.testing.assert_array_equal(tq.fit(tv, tm).numpy(),
                                      np.asarray(jq.fit(jv, jm)))


def test_qsgd_norm_knob_and_bad_method():
    v, mask = _data(8, 512, 2, "q64")
    (jv, jm), (tv, tm) = _both(v, mask)
    tq = make_quantizer("qsgd-5", qsgd_norm="l2")
    jq = jmake_quantizer("qsgd-5", qsgd_norm="l2")
    np.testing.assert_array_equal(tq.fit(tv, tm).numpy(),
                                  np.asarray(jq.fit(jv, jm)))
    with pytest.raises(ValueError, match="unknown norm"):
        make_quantizer("qsgd-5", qsgd_norm="l3").fit(tv, tm)
    from repro_torch.core.quantizers import Quantizer
    with pytest.raises(ValueError, match="unknown method"):
        Quantizer(method="nope").fit(tv, tm)
