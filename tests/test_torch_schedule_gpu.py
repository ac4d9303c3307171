"""The training kernels at the wire widths the bit schedule adds (2 bits:
orq-3, s = 3; 5 bits: orq-17, s = 17), and a schedule's engines
specialized per phase, on the card against the CPU.

Tests marked ``gpu`` need a CUDA device and skip without one; they import
no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_schedule_gpu.py

Tolerance: none for the kernels (``torch.equal``, as in
``test_torch_train_gpu.py``: they repeat the plain versions' float32
operations). The specialized engines' wire units, decodes and EF qdq are
held bit-equal card against CPU on buffers of multiples of 1/64 (every
sum of the level fits exact in any order); their ``group_stats`` within
STATS_RTOL (f32 row reductions in another order).
"""
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core import buckets, encode, prng
from repro_torch.core.comm import wire
from repro_torch.core.comm.exchange import PartitionedExchange
from repro_torch.core.policy import BitSchedule
from repro_torch.kernels import fused_decode, fused_encode
from repro_torch.models import LM

STATS_RTOL = 1e-5
WIDTHS = [(2, 3), (5, 17)]          # (wire bits, levels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _inputs(nb, d, s, seed, masked):
    g = _gen(seed)
    v = torch.randn((nb, d), generator=g) * 0.3
    lv = torch.sort(torch.randn((nb, s), generator=g) * 0.3).values
    rb = torch.randint(-2 ** 31, 2 ** 31, (nb, d), generator=g,
                       dtype=torch.int64).to(torch.int32)
    mask = torch.rand((nb, d), generator=g) > 0.1 if masked else None
    return v, lv, rb, mask


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [2048, 2047, 300])
@pytest.mark.parametrize("bits,s", WIDTHS)
def test_encode_and_qdq_at_new_widths(cuda, bits, s, d, masked):
    v, lv, rb, mask = _inputs(67, d, s, seed=bits * 100 + d, masked=masked)
    lim = fused_encode.clip_limit(v, mask, 2.5) if masked else None
    dev = [None if t is None else t.to(cuda) for t in (v, lv, rb, mask, lim)]
    want = fused_encode.encode_fused_plain(v, lv, rb, mask, lim, bits=bits)
    got = fused_encode.encode_fused_cuda(*dev, bits=bits)
    want_q = fused_encode.qdq_fused_plain(v, lv, rb, mask, lim)
    got_q = fused_encode.qdq_fused_cuda(*dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_q.cpu(), want_q)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("d", [2048, 2047, 37])
@pytest.mark.parametrize("bits,s", WIDTHS)
def test_decodes_at_new_widths(cuda, bits, s, d, L):
    g = _gen(L * 1000 + d + bits)
    words = torch.randint(-2 ** 31, 2 ** 31,
                          (L, 41, encode.packed_words(d, bits)), generator=g,
                          dtype=torch.int64).to(torch.int32)
    levels = torch.sort(torch.randn((L, 41, s), generator=g) * 0.3).values
    for plain, kernel in (
            (fused_decode.decode_fused_mean_plain,
             fused_decode.decode_fused_mean_cuda),
            (fused_decode.decode_fused_each_plain,
             fused_decode.decode_fused_each_cuda)):
        want = plain(words, levels, d=d, bits=bits)
        got = kernel(words.to(cuda), levels.to(cuda), d=d, bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_specialized_engines_card_against_cpu(cuda):
    """One by-rule skeleton of smoke lm-100m, specialized to each phase of
    ``orq@5..1``: every quantized group's wire unit (the fit, then one
    ``encode_fused``), its decodes (``decode_fused_mean`` /
    ``decode_fused_each``) and its EF qdq (``qdq_fused``), the kernels on
    the card and the plain versions on the CPU, bit-equal; the groups and
    their sizes the same in every phase; ``group_stats`` float-close."""
    model = LM(get_smoke_config("lm-100m"))
    ap = model.abstract_params()
    sched = BitSchedule.parse("norm|bias=fp,default=orq@5..1",
                              bucket_size=2048)
    skel = PartitionedExchange.build(
        sched.policy_at(sched.ceil_assignment()), ap,
        paths=model.param_paths(ap), by_rule=True)
    g = _gen(0)
    bufs = [torch.randint(-64, 65, (grp.size,), generator=g).float() / 64
            for grp in skel.layout.groups]
    counters = [fused_encode.encode_fused_cuda, fused_encode.qdq_fused_cuda,
                fused_decode.decode_fused_mean_cuda,
                fused_decode.decode_fused_each_cuda]
    before = [fn.launches for fn in counters]
    for bits in (5, 4, 3, 2, 1):
        eng = skel.specialize(sched.policy_at((None, bits)))
        assert [grp.size for grp in eng.layout.groups] == \
            [grp.size for grp in skel.layout.groups]
        for e, buf in zip(eng.engines, bufs):
            if e.qz.is_identity:
                continue
            assert e.qz.wire_bits_per_element == bits
            d = wire.bucket_len(buf.shape[0], e.qz.bucket_size)
            key = prng.key(bits)
            outs = []
            for dev in ("cpu", cuda):
                bkt, mask = buckets.to_buckets(buf.to(dev), d)
                words, levels = wire.encode(e.qz, bkt, mask, key.to(dev))
                outs.append([words, levels,
                             wire.decode_mean(e.qz, words[None],
                                              levels[None], d),
                             wire.decode_each(e.qz, words[None],
                                              levels[None], d),
                             wire.qdq(e.qz, bkt, mask, key.to(dev))])
            for a, b in zip(outs[1], outs[0], strict=True):
                assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(
            eng.group_stats([b.to(cuda) for b in bufs]).cpu(),
            eng.group_stats(bufs), rtol=STATS_RTOL, atol=0)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [5] * 4
