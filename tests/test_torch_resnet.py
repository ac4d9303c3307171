"""The paper's CIFAR setting in the port against the reference: the
ResNet, the CIFAR-like stream and the example's training step (per-leaf
qdq under crc32-of-path keys, then SGD + momentum with weight decay).

Both sides start from the same weights: numpy draws laid out in the
reference's ``init_resnet`` tree, carried across with ``params_from_jax``. The reference's step is the one of
``examples/paper_cifar_repro.py``, jitted once per method in a module
fixture, and also returns its gradient and the qdq'd gradient, so each
stage of the port can be fed the reference's own inputs.

Tolerances, with their reasons:

* The stream is numpy's, drawn the same way: bit-equal.
* Convolutions and the GroupNorm statistics sum in another order in
  XLA's and oneDNN's kernels: ``rtol 1e-5, atol 1e-5`` for one conv or
  norm, and ``atol 1e-4`` for logits and the loss after the whole net.
  The gradient is ill-conditioned in float32: measured against a float64
  run of the port on the same weights and batch, XLA's and the port's
  float32 gradients are each off by up to ~5e-3 of a leaf's largest
  entry (ResNet-20's first stage; the GroupNorm leaves worst), so they
  are held to ``atol 1e-2`` of that entry.
* The qdq is exact given the gradient and the key for the random-rounding
  schemes (orq-3, orq-9, terngrad): bit-equal. BinGrad-b's levels are
  row means, summed in another order: within 1e-5 relative (the bound of
  the exchange tests), and the side chosen equal away from the midpoint.
* The optimizer step from equal inputs is bit-equal: the fused SGD
  contracts ``wd * p + g``, ``momentum * m + g`` and ``p - lr * m`` into
  fused multiply-adds as XLA does in the jitted step.
* A few training steps from the same start: float-close losses
  (``rtol 1e-4``); the params' change over the run within 2e-2 (fp) and
  0.2 (orq-9) in relative norm per leaf, the bounds of
  ``test_torch_train.py`` (read here: 5e-3 and 7e-2). The gradients
  differ in their last bits, which moves some random-rounding decisions
  of orq-9 by a level from the first step on, and each run then goes its
  own way.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import buckets as jax_buckets
from repro.core import make_quantizer as jax_make_quantizer
from repro.data import cifar_like_batches as jax_batches
from repro.models import resnet as jr
from repro.optim import sgd_momentum as jax_sgd
from repro.optim.optimizers import apply_updates as jax_apply
from repro_torch.convert import params_from_jax
from repro_torch.core import buckets
from repro_torch.core.api import make_quantizer
from repro_torch.data import cifar_like_batches
from repro_torch.kernels import ops
from repro_torch.launch import paper_cifar as pc
from repro_torch.models import resnet as tr
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from torch_test_env import port_test_env  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

CONFIGS = {"example": (jr.ResNetConfig(width=16, blocks_per_stage=1),
                       tr.ResNetConfig(width=16, blocks_per_stage=1)),
           "resnet20": (jr.ResNetConfig(), tr.ResNetConfig())}
RR = ["orq-3", "orq-9", "terngrad"]
STEP_METHODS = ("fp", "orq-9")       # the example's whole step, jitted
LEVEL_RTOL = 1e-5
GRAD_ATOL = 1e-2      # of a leaf's largest entry (see the module doc)
FWD_BATCH = 16
CURVE_STEPS = 3
#: the bounds test_torch_train.py holds a step's update to (relative norm)
CURVE_UPDATE_REL = {"fp": 2e-2, "orq-9": 0.2}


def _np(t):
    return t.detach().cpu().numpy()


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(batch[k]))
            for k in ("images", "labels")}


def _ref_qdq_tree(qz, grads, key):
    """The example's per-leaf qdq under the crc32-of-path keys."""
    if qz.is_identity:
        return grads
    return jax.tree_util.tree_map_with_path(
        lambda p, g: qz.qdq(
            g.reshape(-1),
            jax.random.fold_in(key, zlib.crc32(
                jax.tree_util.keystr(p).encode()) & 0x7FFFFFFF)
        ).reshape(g.shape),
        grads)


def _ref_step(method, cfg):
    """The example's jitted step, returning its gradient and the qdq'd
    gradient beside (params, opt_state, loss)."""
    opt = jax_sgd(momentum=0.9, weight_decay=5e-4)
    qz = jax_make_quantizer(method, bucket_size=2048)

    @jax.jit
    def step(params, opt_state, batch, key):
        loss, grads = jax.value_and_grad(jr.resnet_loss)(params, batch, cfg)
        qgrads = _ref_qdq_tree(qz, grads, key)
        upd, opt_state = opt.update(qgrads, opt_state, params,
                                    jnp.float32(0.05))
        return jax_apply(params, upd), opt_state, loss, grads, qgrads

    return opt, step


def _numpy_weights(jcfg, seed=0):
    """Weights in the reference's tree (its ``init_resnet``'s, traced for
    shapes only), drawn with numpy: conv and head weights N(0, 1/fan_in),
    GroupNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda k: jr.init_resnet(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        if len(sd.shape) > 1:
            fan = int(np.prod(sd.shape[:-1]))
            a = rng.standard_normal(sd.shape) / np.sqrt(fan)
        else:
            a = 0.1 * rng.standard_normal(sd.shape)
            if "_s'" in name:
                a = a + 1.0
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    """Reference weights (numpy) and the port's copy, per config."""
    out = {}
    for name, (jcfg, tcfg) in CONFIGS.items():
        np_tree = _numpy_weights(jcfg)
        jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
        out[name] = (jcfg, tcfg, jp, params_from_jax(np_tree, device="cpu"))
    return out


@pytest.fixture(scope="module")
def batch0():
    return next(jax_batches(64, seed=0))


@pytest.fixture(scope="module")
def small_batch():
    return next(jax_batches(FWD_BATCH, seed=1))


@pytest.fixture(scope="module")
def ref_forward(weights, small_batch):
    """Per config: the reference's loss, logits and gradient."""
    out = {}
    for name, (jcfg, _, jp, _) in weights.items():
        def f(p, b, cfg=jcfg):
            return jr.resnet_loss(p, b, cfg), jr.resnet_logits(
                p, b["images"], cfg)
        fn = jax.jit(jax.value_and_grad(f, has_aux=True))
        (loss, logits), grads = fn(jp, small_batch)
        out[name] = (np.asarray(loss), np.asarray(logits),
                     jax.tree_util.tree_map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def ref_steps(weights, batch0):
    """fp and orq-9: the example's step (jitted once) and its first step
    from the reference weights on batch 0 with the key of step 0."""
    jcfg, _, jp, _ = weights["example"]
    out = {}
    key = jax.random.fold_in(jax.random.key(1), 0)
    for m in STEP_METHODS:
        opt, step = _ref_step(m, jcfg)
        res = step(jp, opt.init(jp), batch0, key)
        out[m] = (opt, step, jax.tree_util.tree_map(np.asarray, res))
    return out


@pytest.fixture(scope="module")
def ref_qdq(ref_steps):
    """Per quantized method: (the step-0 gradient, the reference's per-leaf
    qdq of it under the step-0 keys). orq-9's pair comes from its step;
    the others qdq the fp step's gradient in a jit of the qdq alone."""
    key = jax.random.fold_in(jax.random.key(1), 0)
    grads = ref_steps["fp"][2][3]
    out = {"orq-9": tuple(ref_steps["orq-9"][2][3:5])}
    for m in ("orq-3", "terngrad", "bingrad-b"):
        qz = jax_make_quantizer(m, bucket_size=2048)
        q = jax.jit(lambda g, k, qz=qz: _ref_qdq_tree(qz, g, k))(grads, key)
        out[m] = (grads, jax.tree_util.tree_map(np.asarray, q))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_cifar_like_batches_bit_equal(seed):
    jit, tit = jax_batches(16, seed=seed), cifar_like_batches(
        16, seed=seed, device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(tit)
        assert tb["images"].dtype == torch.float32
        assert tb["labels"].dtype == torch.int32
        np.testing.assert_array_equal(_np(tb["images"]),
                                      np.asarray(jb["images"]))
        np.testing.assert_array_equal(_np(tb["labels"]),
                                      np.asarray(jb["labels"]))


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 3, 16), (3, 2, 16, 32),
                                               (1, 2, 16, 32), (3, 1, 32, 32)])
def test_conv_matches_xla_same_padding(k, stride, cin, cout):
    """XLA's "SAME" pads the odd row / column high at stride 2."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 32, 32, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    ref = np.asarray(lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    out = _np(tr.conv(torch.from_numpy(x), torch.from_numpy(w), stride))
    assert out.shape == ref.shape == (2, 32 // stride, 32 // stride, cout)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jr.conv(x, w, stride)),
                               rtol=1e-5, atol=1e-5)


def test_group_norm_matches():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 8, 8, 32)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    ref = np.asarray(jr.group_norm(x, s, b, 8))
    out = _np(tr.group_norm(*map(torch.from_numpy, (x, s, b)), 8))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_layout_matches(weights, name):
    """The port's own init has the reference's tree: paths, shapes, and
    ``proj`` only where a block changes stride or width."""
    _, tcfg, jp, _ = weights[name]
    mine = tr.init_resnet(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl, _ = tree_flatten_with_path(mine)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(t.shape)
                                               for _, t in tl]
    n = sum(t.numel() for _, t in tl)
    assert (len(tl), n) == {"example": (25, 77_850),
                            "resnet20": (61, 272_282)}[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_loss_grads_from_reference_weights(weights, small_batch,
                                                  ref_forward, name):
    _, tcfg, _, tp = weights[name]
    loss, logits, grads = ref_forward[name]
    tb = _to_torch(small_batch)
    np.testing.assert_allclose(_np(tr.resnet_logits(tp, tb["images"], tcfg)),
                               logits, rtol=0, atol=1e-4)
    tl, tg = pc.loss_and_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(loss), rtol=0, atol=1e-4)
    for (path, g), ref in zip(tree_flatten_with_path(tg)[0],
                              jax.tree_util.tree_leaves(grads)):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(_np(g), ref, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=path)


def _port_qdq(method, grads_np, step_key):
    qz = make_quantizer(method, bucket_size=2048)
    flat, _ = tree_flatten_with_path(params_from_jax(grads_np, device="cpu"))
    return [(p, g, pc.qdq_leaf(qz, g, pc.leaf_key(step_key, p)))
            for p, g in flat]


@pytest.mark.parametrize("method", RR)
def test_per_leaf_qdq_bit_equal(ref_qdq, method):
    """Each leaf's qdq of the reference's gradient under the crc32 key
    equals the reference's ``Quantizer.qdq``, bit for bit."""
    grads, qgrads = ref_qdq[method]
    key = pc.prng.fold_in(pc.prng.key(1), 0)
    for (path, _, q), ref in zip(_port_qdq(method, grads, key),
                                 jax.tree_util.tree_leaves(qgrads)):
        np.testing.assert_array_equal(_np(q).view(np.int32),
                                      ref.view(np.int32), err_msg=path)


def test_per_leaf_qdq_bingrad_b(ref_qdq):
    """BinGrad-b: the levels within 1e-5 relative, and the same side of
    the midpoint b0 for every element not within that of b0."""
    grads, qgrads = ref_qdq["bingrad-b"]
    jqz = jax_make_quantizer("bingrad-b", bucket_size=2048)
    key = pc.prng.fold_in(pc.prng.key(1), 0)
    flips = 0
    for (path, g, q), ref in zip(_port_qdq("bingrad-b", grads, key),
                                 jax.tree_util.tree_leaves(qgrads)):
        bkt, mask = buckets.to_buckets(g.reshape(-1), 2048)
        _, tlv = ops.encode_bingrad(bkt, mask, clip_c=None, lloyd_iters=0)
        jbkt, jmask = jax_buckets.to_buckets(jnp.asarray(_np(g).reshape(-1)), 2048)
        jlv = np.asarray(jqz.fit(jbkt, jmask))
        np.testing.assert_allclose(_np(tlv), jlv, rtol=LEVEL_RTOL, atol=0,
                                   err_msg=path)
        n = g.numel()
        b0 = np.repeat(0.5 * (jlv[:, 0] + jlv[:, 1]), 2048)[:n]
        vals = _np(g).reshape(-1)
        side_t = np.isclose(_np(q).reshape(-1),
                            np.repeat(_np(tlv)[:, 1], 2048)[:n], rtol=0,
                            atol=0)
        side_r = ref.reshape(-1) == np.repeat(jlv[:, 1], 2048)[:n]
        away = np.abs(vals - b0) > LEVEL_RTOL * np.abs(b0).max()
        np.testing.assert_array_equal(side_t[away], side_r[away],
                                      err_msg=path)
        flips += int((side_t != side_r).sum())
    print(f"bingrad-b sides differing at b0: {flips}")


@pytest.mark.parametrize("method", STEP_METHODS)
def test_one_step_bit_equal(weights, ref_steps, method):
    """From the reference's qdq'd gradient, the port's fused SGD with
    weight decay gives the reference's params and momentum bit for bit."""
    _, _, jp, tp = weights["example"]
    opt_j, _, res = ref_steps[method]
    new_p, new_s, _, _, qgrads = res
    opt, _ = pc.make_step(method, CONFIGS["example"][1])
    g = params_from_jax(qgrads, device="cpu")
    p, s = pc.optimizers.step(opt, g, opt.init(tp), tp, pc.LR)
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(new_p)):
        np.testing.assert_array_equal(_np(a).view(np.int32),
                                      b.view(np.int32))
    for a, b in zip(tree_leaves(s), jax.tree_util.tree_leaves(new_s)):
        np.testing.assert_array_equal(_np(a).view(np.int32),
                                      b.view(np.int32))


@pytest.mark.parametrize("method", STEP_METHODS)
def test_training_curve_matches_reference_loop(weights, ref_steps, method):
    """``paper_cifar.train`` from the reference weights against the
    example's loop (its batches, its keys), a few steps."""
    jcfg, tcfg, jp, tp = weights["example"]
    opt, step, _ = ref_steps[method]
    params, state = jp, opt.init(jp)
    data = jax_batches(64, seed=0)
    ref_losses = []
    for i in range(CURVE_STEPS):
        params, state, loss, _, _ = step(
            params, state, next(data),
            jax.random.fold_in(jax.random.key(1), i))
        ref_losses.append(float(loss))
    fresh = next(data)
    acc = float((jnp.argmax(jr.resnet_logits(params, fresh["images"], jcfg),
                            -1) == fresh["labels"]).mean())
    run = pc.train(method, CURVE_STEPS, cfg=tcfg, device="cpu", params=tp)
    print(f"{method} losses port {run.losses} reference {ref_losses}, "
          f"accuracy port {run.accuracy} reference {acc}")
    np.testing.assert_allclose(run.losses, ref_losses, rtol=1e-4, atol=0)
    assert abs(run.accuracy - acc) <= 1 / 64     # one near-tie at most
    worst = 0.0
    for a, b, p0 in zip(tree_leaves(run.params),
                        jax.tree_util.tree_leaves(params), tree_leaves(tp)):
        upd_t, upd_r = _np(a) - _np(p0), np.asarray(b) - _np(p0)
        worst = max(worst, np.linalg.norm(upd_t - upd_r)
                    / max(np.linalg.norm(upd_r), 1e-30))
    print(f"{method}: worst relative update difference {worst:.3e}")
    assert worst <= CURVE_UPDATE_REL[method]
