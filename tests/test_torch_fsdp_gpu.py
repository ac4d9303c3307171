"""The fsdp and two-level slice on the card: the CUDA kernels at the shapes
only this slice gives them, against their plain PyTorch versions, and the
fsdp exchanges on the card against the same exchanges on the CPU.

Shapes (lm-100m, bucket 2048; name -> (workers L, rows per worker, d,
valid values in each worker's last row)): the fsdp reduce-scatter's L = 4
chunks, the two-level exchange of the 67,642,752-value intra shard across
2 pods, that shard as one buffer (33,029 rows), and the per-leaf fsdp
slices of one attention weight at L = 1 and of the embedding at L = 4.
The fsdp buffer at L = 1 (66,058 rows) is the training shape of
``test_torch_train_gpu.py``.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fsdp_gpu.py

Tolerance: none for ``encode_fused``, ``qdq_fused`` and the decodes (bit-
equal by value). BinGrad-b's levels are bit-equal to
``fused_bingrad.kernel_order_levels`` and its words the exact threshold of
its own levels (bit-equal to the plain fit on multiples of 1/64). The
exchanges run on buffers of multiples of 1/64 (every sum of a fit exact in
any order): outputs and residuals bit-equal, card (NCCL, a world of one)
against CPU (a gloo group of the same world).
"""
import tempfile

import pytest
import torch
import torch.distributed as dist

from repro_torch.core import encode
from repro_torch.core import levels as lvmod
from repro_torch.kernels import fused_bingrad, fused_decode, fused_encode

FSDP_SHAPES = {"fsdp_L4_chunks": (4, 16_515, 2048, 704),
               "two_level_pods2": (2, 16_515, 2048, 704),
               "intra_shard": (1, 33_029, 2048, 1408),
               "leaf_wq_L1": (1, 288, 2048, 2048),
               "leaf_embed_L4": (4, 3072, 2048, 2048)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _inputs(case, dev, seed=0, q64=False):
    L, nb, d, last = FSDP_SHAPES[case]
    g = torch.Generator().manual_seed(seed)
    one = torch.arange(nb * d) < (nb - 1) * d + last
    mask = one.repeat(L).reshape(L * nb, d)
    v = (torch.randint(-64, 65, (L * nb, d), generator=g).float() / 64
         if q64 else torch.randn((L * nb, d), generator=g) * 1e-3)
    v = torch.where(mask, v, 0.0)
    rb = torch.randint(-2 ** 31, 2 ** 31, (L * nb, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    return v.to(dev), mask.to(dev), rb.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FSDP_SHAPES))
def test_encode_and_qdq_at_fsdp_shapes(cuda, case):
    v, mask, rb = _inputs(case, cuda)
    lv = lvmod.orq_levels(v, mask, 3)
    args = (v, lv, rb, mask, None)
    assert torch.equal(fused_encode.encode_fused_cuda(*args, bits=4),
                       fused_encode.encode_fused_plain(*args, bits=4))
    assert torch.equal(fused_encode.qdq_fused_cuda(*args, mode="rr"),
                       fused_encode.qdq_fused_plain(*args, mode="rr"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FSDP_SHAPES))
def test_decodes_at_fsdp_shapes(cuda, case):
    L, nb, d, _ = FSDP_SHAPES[case]
    g = torch.Generator().manual_seed(L)
    words = torch.randint(-2 ** 31, 2 ** 31,
                          (L, nb, encode.packed_words(d, 4)), generator=g,
                          dtype=torch.int64).to(torch.int32).to(cuda)
    levels = torch.sort(torch.randn((L, nb, 9), generator=g)).values.to(cuda)
    for cuda_fn, plain in (
            (fused_decode.decode_fused_mean_cuda,
             fused_decode.decode_fused_mean_plain),
            (fused_decode.decode_fused_each_cuda,
             fused_decode.decode_fused_each_plain)):
        assert torch.equal(cuda_fn(words, levels, d=d, bits=4),
                           plain(words, levels, d=d, bits=4))


@pytest.mark.gpu
@pytest.mark.parametrize("q64", [True, False])
@pytest.mark.parametrize("case", sorted(FSDP_SHAPES))
def test_bingrad_encode_at_fsdp_shapes(cuda, case, q64):
    v, mask, _ = _inputs(case, cuda, seed=1, q64=q64)
    words, lv = fused_bingrad.encode_bingrad_fused_cuda(v, mask, None)
    order = fused_bingrad.kernel_order_levels(v, mask, None)
    assert torch.equal(lv.view(torch.int32), order.view(torch.int32))
    own = fused_encode.encode_fused_plain(v, lv, None, mask, None, bits=1,
                                          mode="bin")
    assert torch.equal(words, own)
    if q64:
        want_w, want_l = fused_bingrad.encode_bingrad_fused_plain(v, mask,
                                                                  None)
        assert torch.equal(lv, want_l) and torch.equal(words, want_w)


@pytest.fixture(scope="module")
def nccl_world():
    """A NCCL world of one (file store) and a gloo group of it; the
    world a running process group of another module provides is used
    as it is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    created = not dist.is_initialized()
    if created:
        torch.cuda.set_device(0)
        tmp = tempfile.mkdtemp(prefix="repro_torch_gpu_world_")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
    gloo = dist.new_group(ranks=[0], backend="gloo")
    yield gloo
    dist.destroy_process_group(gloo)
    if created:
        dist.destroy_process_group()


def _smoke_fsdp(scheme, group):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.comm.fsdp_exchange import FsdpExchange
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.train.step import plan_sharding_shapes
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    plan = plan_sharding_shapes(model, ap, dp_axes=("data",),
                                axis_sizes={"data": 1})
    return FsdpExchange.build(
        QuantPolicy.parse(scheme, bucket_size=512), ap, ("data",),
        paths=plan.paths, shard_dims=plan.full_shard_dims(), n_shards=1,
        group=group), plan


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["orq-9", "bingrad-b",
                                    "norm|bias=fp,default=orq-9"])
def test_fsdp_exchange_card_vs_cpu(nccl_world, scheme):
    from repro_torch.core import prng
    out = {}
    for where, group in (("cuda", None), ("cpu", nccl_world)):
        fex, _ = _smoke_fsdp(scheme, group)
        g = torch.Generator().manual_seed(3)
        bufs = [(torch.randint(-64, 65, (grp.size,), generator=g).float()
                 / 64).to(where) for grp in fex.layout.groups]
        ef = tuple(None if n is None else
                   (torch.randint(-8, 9, (n,), generator=g).float()
                    / 512).to(where) for n in fex.ef_group_sizes())
        outs, res = fex.exchange_with_residuals(bufs, prng.key(5, device=where),
                                                None, ef)
        out[where] = [t.cpu() for t in list(outs) + [r for r in res
                                                      if r is not None]]
    for a, b in zip(out["cuda"], out["cpu"], strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["orq-9", "bingrad-b"])
def test_per_leaf_fsdp_exchange_card_vs_cpu(nccl_world, scheme):
    """Each leaf slice's reduce-scatter (``gather.make_fsdp_gather``'s
    backward) on the card and on the CPU."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.comm.fsdp_exchange import reduce_scatter_mean_block
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import LM
    from repro_torch.utils.pytree import tree_leaves
    _, plan = _smoke_fsdp(scheme, None)
    qz = QuantPolicy.parse(scheme, bucket_size=512).resolve("x") \
        .to_quantizer()
    model = LM(get_smoke_config("lm-100m"))
    g = torch.Generator().manual_seed(4)
    for path, leaf in zip(tree_leaves(plan.paths),
                          tree_leaves(model.abstract_params())):
        shape = tuple(leaf.shape[1:] if path.startswith("g") else leaf.shape)
        x = torch.randint(-64, 65, shape, generator=g).float() / 64
        dim = plan.gather_dims[path]
        got = reduce_scatter_mean_block(x.cuda(), qz, prng.key(6,
                                                               device="cuda"),
                                        None, dim=dim)
        want = reduce_scatter_mean_block(x, qz, prng.key(6), nccl_world,
                                         dim=dim)
        assert torch.equal(got.cpu(), want), path
