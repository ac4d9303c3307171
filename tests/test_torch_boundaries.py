"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points run on the card unless the caller asks for the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MLAParams, MoEParams, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import LM
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.kv_cache import KVQuantSpec, init_kv_pools
from torch_test_env import port_test_env  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_trace.py",
    ROOT / "tools" / "train_reading.py"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()
    port = ROOT / "src" / "repro_torch"
    for rel in ("launch/paper_cifar.py", "models/resnet.py",
                "configs/qwen15_32b.py", "configs/command_r_plus_104b.py",
                "configs/chameleon_34b.py", "configs/gemma2_9b.py",
                "configs/gemma3_27b.py", "models/moe.py",
                "configs/mixtral_8x22b.py", "configs/deepseek_v2_236b.py",
                "models/ssm.py", "models/rwkv.py",
                "configs/jamba_v01_52b.py", "configs/rwkv6_3b.py",
                "configs/whisper_base.py"):
        assert port / rel in PORT_FILES, rel


@pytest.mark.parametrize("n", [0, 3])
def test_cut_depth_refuses_a_depth_the_config_lacks(n):
    """``cut_depth`` (the train launcher's ``--layers``) keeps 1 to
    num_layers layers, widths unchanged."""
    from repro_torch.configs.base import cut_depth

    cfg = get_smoke_config("deepseek-v2-236b")
    cut = cut_depth(cfg, 1)
    assert (cut.num_layers, cut.d_model, cut.mla) == (1, cfg.d_model, cfg.mla)
    assert cut_depth(cfg, None) is cfg
    with pytest.raises(ValueError, match="num_layers"):
        cut_depth(cfg, n)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_refuse_unported_arch_by_name(launcher, capsys):
    """Every reference config is registered. whisper-base serves on the
    dense path (its frame embeddings drawn by the launcher, the cache
    warmed before the clock); the training launcher refuses it while
    parsing, by name, because its token stream carries no frame
    embeddings: whisper trains through ``make_train_step``."""
    from repro.configs.base import list_archs as reference_archs
    from repro_torch.configs.base import list_archs
    from repro_torch.launch import train as train_launcher

    assert list_archs() == reference_archs()
    args = ["--arch", "whisper-base", "--smoke", "--device", "cpu"]
    if launcher == "serve":
        r = serve_launcher.serve(args + ["--batch", "8", "--prompt-len", "8",
                                         "--gen", "3", "--max-len", "128",
                                         "--prefill-chunk", "4"])
        assert r["path"] == "dense" and r["engine"] is None
        assert r["prefill_chunk"] == 4 and r["tokens"].shape == (8, 3)
        assert r["cache_bytes"] == 648_192 and r["cross_bytes"] == 7_680
        assert r["warm_cache_s"] is not None
        return
    with pytest.raises(SystemExit) as e:
        train_launcher.train(args)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "whisper-base" in err and "make_train_step" in err
    assert "enc_embeds" in err


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_cuda_sources_present():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    for name in ("encode_fused.cu", "decode_attend.cu"):
        text = (csrc / name).read_text()
        assert "Replaces:" in text and "src/repro/kernels/" in text


def test_engine_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    model = LM(get_smoke_config("lm-100m"))
    cfg = ServeConfig(kv_quant="orq-9", page_size=4, max_batch=1,
                      max_pages_per_seq=2, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, {}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        serve_launcher.serve(["--smoke", "--kv-quant", "orq-9"])


def test_init_and_pools_without_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    model = LM(get_smoke_config("lm-100m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    kvq = KVQuantSpec("orq-9", model.cfg.num_kv_heads,
                      model.cfg.resolved_head_dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_pools(model, kvq, num_pages=4, page_size=4)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu"
    pools = init_kv_pools(model, kvq, num_pages=4, page_size=4, device="cpu")
    assert pools[0]["pos0"]["kw"].device.type == "cpu"


def test_cpu_on_request_and_bad_devices():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_launcher_needs_kv_quant():
    """``--kv-quant`` selects the paged engine; without it the launcher
    serves through the dense ring-buffer cache, and no engine exists."""
    args = ["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len",
            "4", "--gen", "2", "--max-len", "16"]
    dense = serve_launcher.serve(args)
    assert dense["path"] == "dense" and dense["engine"] is None
    paged = serve_launcher.serve(args + ["--kv-quant", "bf16",
                                         "--page-size", "4"])
    assert paged["path"] == "paged" and paged["engine"] is not None
    np.testing.assert_array_equal(dense["tokens"], paged["tokens"])


@pytest.mark.parametrize("change", [{"norm": "ln"}, {"kind": "mamba"},
                                    {"cross_attn": True}, {"kind": "rwkv"},
                                    {"kind": "conv"}])
def test_unported_layer_kinds_point_to_the_roadmap(change):
    """Layer norm, cross-attention, Mamba and RWKV layers are admitted; a
    layer kind the port does not know is refused by name, pointing to
    ROADMAP.md as the other refusals do."""
    import dataclasses

    from repro_torch.models.blocks import check_ported_layer
    from repro_torch.models.model import build_layer_specs

    cfg = get_smoke_config("lm-100m")
    spec = build_layer_specs(cfg)[0]
    check_ported_layer(cfg, spec)
    if "norm" in change:
        cfg = dataclasses.replace(cfg, **change)
    else:
        spec = dataclasses.replace(spec, **change)
    if change.get("kind") != "conv":
        check_ported_layer(cfg, spec)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        check_ported_layer(cfg, spec)
    assert "'conv'" in str(e.value)


@pytest.mark.parametrize("change,message", [
    ({"moe": MoEParams(num_experts=4, top_k=2, d_ff_expert=64),
      "moe_every": 1}, "paged KV serving does not support MoE layers"),
    ({"mla": MLAParams(q_lora=32, kv_lora=16, rope_head_dim=8,
                       nope_head_dim=16, v_head_dim=16)},
     "paged KV serving supports GQA attention stacks only"),
    ({"arch": "jamba-v0.1-52b"},
     "paged KV serving supports GQA attention stacks only"),
    ({"arch": "rwkv6-3b"},
     "paged KV serving supports GQA attention stacks only"),
    ({"arch": "whisper-base"},
     "paged KV serving supports GQA attention stacks only"),
])
def test_paged_engine_refuses_moe_and_mla(change, message):
    """MoE, MLA, Mamba, RWKV and encoder-decoder models run in training
    and on the dense serve path; the paged engine refuses them as the
    reference's does (MoE capacity dispatch couples the tokens of a
    batch; a recurrent layer has no KV pages; the cross K/V of an encoder
    have no pages either)."""
    import dataclasses

    model = LM(get_smoke_config(change["arch"]) if "arch" in change else
               dataclasses.replace(get_smoke_config("lm-100m"), **change))
    cfg = ServeConfig(kv_quant="orq-9", page_size=4, max_batch=1,
                      max_pages_per_seq=2, prefill_chunk=4)
    with pytest.raises(ValueError, match=message) as got:
        Engine(model, model.init(torch.Generator().manual_seed(0),
                                 device="cpu"), cfg, device="cpu")
    if change.get("arch") == "whisper-base":
        from repro.configs.base import get_smoke_config as jget_smoke_config
        from repro.models import LM as JLM
        from repro.serve import Engine as JEngine

        with pytest.raises(ValueError) as want:
            JEngine._validate(JLM(jget_smoke_config("whisper-base")))
        assert str(got.value) == str(want.value)
        assert "encoder=True" in str(got.value)
