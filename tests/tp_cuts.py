"""Smoke configs cut so that a dim does not split over a model axis of 4,
for the model-axis tests (``test_torch_tp_train.py``,
``test_torch_tp_serve.py``): whisper's query heads (2), which run
replicated, or its KV heads (2 of 4, self- and cross-attention), which
each rank cuts to the heads its query heads read. ``REFUSED``: cuts that
``LM.check_tp`` refuses at ``n`` model ranks (3 experts, RWKV's 1 head,
MLA's 2 heads).
"""
import dataclasses

from repro_torch.configs.base import get_smoke_config

CUTS = {
    "whisper-base/H2": lambda c: dict(num_heads=2, num_kv_heads=2),
    "whisper-base/KV2": lambda c: dict(num_kv_heads=2),
}
REFUSED = {
    "mixtral-8x22b/E3": (2, lambda c: dict(moe=dataclasses.replace(
        c.moe, num_experts=3))),
    "rwkv6-3b/H1": (2, lambda c: dict(rwkv=dataclasses.replace(
        c.rwkv, head_dim=c.d_model))),
    "deepseek-v2-236b/H2": (4, lambda c: dict(num_heads=2, num_kv_heads=2)),
}


def smoke(arch):
    """The smoke config of ``arch``, or of a cut in ``CUTS`` or
    ``REFUSED``."""
    cfg = get_smoke_config(arch.split("/")[0])
    if "/" not in arch:
        return cfg
    cut = CUTS[arch] if arch in CUTS else REFUSED[arch][1]
    return dataclasses.replace(cfg, **cut(cfg))
