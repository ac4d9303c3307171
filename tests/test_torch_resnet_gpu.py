"""The CIFAR setting's kernels on the card against their plain PyTorch
versions, at the ResNets' own leaves.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_resnet_gpu.py

Tolerances: each leaf's qdq (one ``qdq_fused`` launch; BinGrad-b also one
``encode_bingrad_fused`` for its levels) is bit-equal to the CPU's for the
random-rounding schemes (the kernel repeats the plain version's float32
operations); BinGrad-b's levels are row sums in another order, so its
values are within 1e-5 of the leaf's largest entry but for at most 0.1%
of them, which the midpoint puts on the other side. A float32 gradient
of these nets is good to ~5e-3 of a leaf's largest entry (the CPU tests
hold both frameworks against float64), so card and CPU agree within
1e-2 of it.
"""
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.api import make_quantizer
from repro_torch.data import cifar_like_batches
from repro_torch.kernels import fused_bingrad, fused_encode
from repro_torch.launch import paper_cifar as pc
from repro_torch.models.resnet import ResNetConfig, init_resnet
from repro_torch.utils.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.utils.pytree import tree_map

CONFIGS = {"example": (ResNetConfig(width=16, blocks_per_stage=1), 25),
           "resnet20": (ResNetConfig(), 61)}
LEVEL_RTOL = 1e-5
FLIP_SHARE = 1e-3
GRAD_ATOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _grads(cfg, seed=0):
    """A gradient tree of ``cfg``'s ResNet from the CPU (fixed inputs)."""
    params = init_resnet(torch.Generator().manual_seed(seed), cfg, "cpu")
    batch = next(cifar_like_batches(pc.BATCH, seed=seed, device="cpu"))
    return params, batch, pc.loss_and_grads(params, batch, cfg)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("method", ["terngrad", "orq-3", "orq-9",
                                    "bingrad-b"])
def test_per_leaf_qdq_card_equals_cpu(cuda, config, method):
    cfg, leaves = CONFIGS[config]
    _, _, g = _grads(cfg)
    qz = make_quantizer(method, bucket_size=pc.BUCKET)
    key = prng.fold_in(prng.key(1), 3)
    want = pc.qdq_grads(qz, g, key)
    fused_encode.qdq_fused_cuda.launches = 0
    fused_bingrad.encode_bingrad_fused_cuda.launches = 0
    got = pc.qdq_grads(qz, tree_map(lambda t: t.to(cuda), g), key.to(cuda))
    torch.cuda.synchronize()
    assert fused_encode.qdq_fused_cuda.launches == leaves
    assert fused_bingrad.encode_bingrad_fused_cuda.launches == (
        leaves if method == "bingrad-b" else 0)
    flips = total = 0
    for (path, a), b in zip(tree_flatten_with_path(got)[0],
                            tree_leaves(want)):
        a = a.cpu()
        total += b.numel()
        if method == "bingrad-b":
            tol = LEVEL_RTOL * float(b.abs().max())
            flips += int(((a - b).abs() > tol).sum())
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path
    assert flips <= FLIP_SHARE * total


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(CONFIGS))
def test_gradient_card_close_to_cpu(cuda, config):
    cfg, _ = CONFIGS[config]
    params, batch, g_cpu = _grads(cfg)
    _, g_dev = pc.loss_and_grads(tree_map(lambda t: t.to(cuda), params),
                                 {k: v.to(cuda) for k, v in batch.items()},
                                 cfg)
    for (path, a), b in zip(tree_flatten_with_path(g_dev)[0],
                            tree_leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= GRAD_ATOL * float(b.abs().max()), (path, err)


@pytest.mark.gpu
@pytest.mark.parametrize("method", pc.METHODS)
def test_train_on_card_launches(cuda, method):
    """``paper_cifar.train`` on the card: one ``qdq_fused`` a leaf a step
    (BinGrad-b also one ``encode_bingrad_fused``), none for fp."""
    cfg, leaves = CONFIGS["example"]
    fused_encode.qdq_fused_cuda.launches = 0
    fused_bingrad.encode_bingrad_fused_cuda.launches = 0
    run = pc.train(method, 2, cfg=cfg, device=cuda)
    q = 0 if method == "fp" else 2 * leaves
    assert fused_encode.qdq_fused_cuda.launches == q
    assert fused_bingrad.encode_bingrad_fused_cuda.launches == (
        q if method == "bingrad-b" else 0)
    assert all(x == x for x in run.losses) and 0 <= run.accuracy <= 1
