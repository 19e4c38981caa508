"""The port's boundaries: what it imports, where it runs, what it refuses.

* No module of dynamo_tpu_torch and no line of chip_smoke.py imports
  jax, dynamo_tpu, ml_dtypes, safetensors, transformers, aiohttp or
  prometheus_client (an AST scan),
  and importing the whole package in a fresh interpreter loads none of
  them (a GPU host need have none of them).
* Entry points default to CUDA and raise on a machine without it; they
  never fall back to the CPU.  chip_smoke.py fails without CUDA and
  without the rest of the repository, printing no result.
* A config field of a JAX-engine feature the port lacks raises when set;
  the fields of ported features take their values, and reject invalid
  ones with the JAX engine's error.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import PRESETS

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dynamo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu", "ml_dtypes", "safetensors",
             "transformers", "aiohttp", "prometheus_client")
# modules the import checks must reach (a later slice's additions)
REQUIRED = ("models/loader.py", "models/weight_cache.py",
            "engine/loader_cache.py", "ops/fused_sampling.py",
            "disagg/__init__.py", "disagg/transfer.py", "disagg/broker.py",
            "disagg/device_transfer.py",
            "ops/kv_transfer.py", "runtime/retry.py", "kvbm/pools.py",
            "kvbm/breaker.py", "kvbm/object_store.py", "kvbm/object_io.py",
            "kvbm/residency.py", "kvbm/manager.py", "kvbm/remote.py",
            "spec/__init__.py", "spec/ngram.py", "spec/verify.py",
            "spec/draft.py", "lora/__init__.py", "lora/bank.py",
            "lora/source.py", "guided/__init__.py", "guided/json_prefix.py",
            "frontend/__init__.py", "frontend/tokenizer.py",
            "obs/__init__.py", "obs/slo.py", "obs/compile_watch.py",
            "obs/costs.py", "obs/kv_ledger.py", "runtime/metrics.py",
            "runtime/system_status.py", "planner/__init__.py",
            "planner/metrics.py", "router/tiered_index.py",
            "runtime/aio.py", "runtime/push_router.py",
            "runtime/component.py", "runtime/http_server.py",
            "router/__init__.py", "router/indexer.py",
            "router/selector.py", "router/sequences.py",
            "router/targets.py", "router/replica_sync.py",
            "router/kv_router.py", "lora/routing.py", "obs/forensics.py",
            "frontend/parsers.py", "frontend/preprocessor.py",
            "frontend/request_trace.py", "frontend/affinity.py",
            "frontend/pipeline.py", "frontend/service.py",
            "frontend/__main__.py", "disagg/prefill_router.py",
            "multimodal/hop.py", "frontend/anthropic.py",
            "frontend/openai_extra.py", "router/native_indexer.py",
            "frontend/kserve.py", "frontend/kserve_pb2.py",
            "profiler/__init__.py", "profiler/profile.py",
            "profiler/__main__.py", "planner/predictor.py",
            "planner/perf_model.py", "planner/connectors.py",
            "planner/planner.py", "planner/__main__.py", "obs/fleet.py",
            "obs/report.py", "router/__main__.py", "chaos/__init__.py",
            "operator/__init__.py", "operator/spec.py",
            "operator/reconciler.py", "operator/__main__.py")
# the KVBM tiers' fields (ported with kvbm/) and the knobs that came
# with them, at the JAX engine's defaults
KVBM_FIELDS = ("host_cache_blocks", "disk_cache_dir", "disk_cache_blocks",
               "object_store_dir")
KVBM_KNOBS = ("object_store_ttl_s", "kvbm_remote", "kvbm_remote_max_blocks",
              "offload_watermark_blocks", "offload_batch",
              "kv_io_deadline_s", "kv_breaker_threshold",
              "kv_breaker_cooldown_s")


def _package_modules():
    """The package's .py files, leaving out the git-ignored build
    directory (generated output, not source)."""
    return sorted(p for p in PKG.rglob("*.py")
                  if "_build" not in p.relative_to(PKG).parts[:-1])


def _port_sources():
    return _package_modules() + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_port_module_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    assert {str(p.relative_to(PKG)) for p in sources[:-1]} >= set(REQUIRED)
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in sources for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_neither():
    mods = sorted({".".join(p.relative_to(REPO).with_suffix("").parts)
                   .removesuffix(".__init__") for p in _package_modules()})
    code = (
        "import sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_is_the_default_and_absent_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(EngineConfig(model_config=PRESETS["tiny"]))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, PRESETS["tiny"])
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _non_default(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    if default is None:
        return "/tmp/x"
    return "something-else"


@pytest.mark.parametrize("field", ["sp"])
def test_unported_config_field_raises(field):
    """No field is left unported: `field`, the last one the port refused,
    takes a value other than its default, and every field of JAX's
    EngineConfig is one of the port's (the config module has no table of
    refused fields any more)."""
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu_torch.engine import config as config_module

    assert not hasattr(config_module, "_UNPORTED")
    value = _non_default(getattr(EngineConfig(), field))
    assert getattr(EngineConfig(**{field: value}), field) == value
    jax_fields = {f.name for f in dataclasses.fields(JaxEngineConfig)}
    assert jax_fields <= {f.name for f in dataclasses.fields(EngineConfig)}


@pytest.mark.parametrize("field", ["model_path", "sampling_epilogue",
                                   "role", "spec_decode", "lora_max_adapters",
                                   "peak_hbm_gbps", "tp", "dp", "sp",
                                   *KVBM_FIELDS])
def test_ported_config_field_accepted(field, tmp_path):
    """Fields that left _UNPORTED when their features were ported take a
    valid value; sampling_epilogue rejects others with the JAX engine's
    ValueError, role with the JAX CLI's choices; the KVBM fields and
    their knobs default as the JAX engine's do; spec_decode and its knobs
    default as JAX's, take "ngram" and "draft", and reject others with
    the JAX engine's ValueError; lora_max_adapters and its knobs (and
    the SLO input's) default as JAX's and take a bank size; peak_hbm_gbps
    (the roofline MBU gauges' peak) defaults as JAX's, takes a rate and
    is the CLI's --peak-hbm-gbps, as in the JAX CLI; tp, dp and sp (the
    mesh, parallel/) default as JAX's and take a size, and a size below
    1 raises."""
    if field in ("tp", "dp", "sp"):
        from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig

        assert getattr(EngineConfig(), field) \
            == getattr(JaxEngineConfig(), field) == 1
        assert getattr(EngineConfig(**{field: 4}), field) == 4
        with pytest.raises(ValueError, match=">= 1"):
            EngineConfig(**{field: 0})
        return
    if field == "peak_hbm_gbps":
        from dynamo_tpu.engine.__main__ import build_args as jax_args
        from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
        from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

        assert EngineConfig().peak_hbm_gbps \
            == JaxEngineConfig().peak_hbm_gbps == 0.0
        assert EngineConfig(peak_hbm_gbps=3350.0).peak_hbm_gbps == 3350.0
        argv = ["--peak-hbm-gbps", "3350", "--peak-tflops", "989"]
        ours, theirs = build_args().parse_args(argv), jax_args().parse_args(
            argv)
        assert ours.peak_hbm_gbps == theirs.peak_hbm_gbps == 3350.0
        cfg = engine_config(ours)
        assert (cfg.peak_hbm_gbps, cfg.peak_tflops) == (3350.0, 989.0)
        return
    if field == "lora_max_adapters":
        from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig

        for name in ("lora_max_adapters", "lora_rank", "lora_dir",
                     "slo_yield_burn", "slo_burn_stale_s"):
            assert getattr(EngineConfig(), name) \
                == getattr(JaxEngineConfig(), name)
        cfg = EngineConfig(lora_max_adapters=4, lora_rank=8,
                           lora_dir=str(tmp_path))
        assert (cfg.lora_max_adapters, cfg.lora_rank, cfg.lora_dir) == (
            4, 8, str(tmp_path))
        return
    if field == "spec_decode":
        from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
        from dynamo_tpu.engine import JaxEngine

        for name in ("spec_decode", "spec_k", "spec_ngram_max",
                     "spec_ngram_min", "spec_draft_config",
                     "spec_draft_model_path", "spec_draft_model",
                     "spec_accept_min", "spec_probe_interval"):
            assert getattr(EngineConfig(), name) \
                == getattr(JaxEngineConfig(), name)
        for mode in ("ngram", "draft"):
            assert EngineConfig(spec_decode=mode).spec_decode == mode
        with pytest.raises(ValueError) as want:
            JaxEngine(JaxEngineConfig(model="tiny", spec_decode="medusa"))
        with pytest.raises(ValueError) as got:
            EngineConfig(spec_decode="medusa")
        assert str(got.value) == str(want.value)
        return
    if field in KVBM_FIELDS:
        from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig

        for name in (field, *KVBM_KNOBS):
            assert getattr(EngineConfig(), name) \
                == getattr(JaxEngineConfig(), name)
        value = 8 if field.endswith("blocks") else str(tmp_path / "d")
        assert getattr(EngineConfig(**{field: value}), field) == value
        return
    if field == "role":
        from dynamo_tpu.engine.__main__ import build_args as jax_args
        from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
        from dynamo_tpu_torch.engine.__main__ import build_args

        choices = [a.choices for p in (jax_args(), build_args())
                   for a in p._actions if a.dest == "role"]
        assert choices[0] == choices[1] == ["both", "prefill", "decode"]
        for role in choices[0]:
            assert EngineConfig(role=role).role == role
        with pytest.raises(ValueError, match="role"):
            EngineConfig(role="router")
        # the frame bound that comes with it, at the JAX default
        assert EngineConfig().transfer_chunk_bytes \
            == JaxEngineConfig().transfer_chunk_bytes
        return
    if field == "sampling_epilogue":
        for mode in ("off", "fused"):
            assert EngineConfig(sampling_epilogue=mode).sampling_epilogue \
                == mode
        from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
        from dynamo_tpu.engine import JaxEngine

        with pytest.raises(ValueError) as want:
            JaxEngine(JaxEngineConfig(model="tiny",
                                      sampling_epilogue="pallas"))
        with pytest.raises(ValueError) as got:
            EngineConfig(sampling_epilogue="pallas")
        assert str(got.value) == str(want.value)
        return
    from test_torch_loader import write_checkpoint

    path = write_checkpoint(tmp_path / "tiny-ck", "qwen3")
    cfg = EngineConfig(model_path=path)
    m = cfg.resolve_model()
    assert (m.name, m.qk_norm, m.d_model, m.dtype) == (
        "tiny-ck", True, 64, torch.bfloat16)
    assert cfg.served_name == "tiny-ck"
    assert cfg.resolve_eos_ids() == (2, 7)
    # the engine's attention-impl overrides apply to a checkpoint's config
    assert EngineConfig(model_path=path,
                        attn_impl="torch").resolve_model().attn_impl == "torch"


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError):
        EngineConfig(attn_impl="pallas")
    with pytest.raises(ValueError):
        EngineConfig(packed_attn_impl="xla")
    cfg = EngineConfig(model="tiny-gqa", attn_impl="torch")
    assert cfg.resolve_model().attn_impl == "torch"
    assert cfg.resolve_model().n_kv_heads == 2
