"""The port's checkpoint loader and weight cache against the JAX package's.

Checkpoints are synthesized here in the HF layout (config.json, two
*.safetensors shards written by a standard-library writer below,
tokenizer files), with random weights from numpy and norms away from 1
so a mapping mistake shows:

* load_hf_config gives JAX's LlamaConfig field by field (Llama, Qwen3
  with qk_norm, tied and untied, Mixtral with its experts), and JAX's
  DeepseekConfig for DeepSeek V2 and V3 checkpoints.
* load_params equals JAX's load_params carried through models/convert.py
  bit for bit, in fp32 and in bf16 (bf16 files and fp32 files cast to
  bf16), with the tied and untied lm_head rules; an unmapped tensor and
  a missing layer raise JAX's errors; a bf16 file whose tensors start at
  odd offsets loads equal to the aligned one, through one counted copy
  per tensor.  Mixtral's per-expert tensors, split across the shards,
  load as JAX's stacked [E, ...] arrays, bit-equal; a missing expert
  raises JAX's error; the stacks go through the weight cache.  DeepSeek
  V2 and V3 checkpoints (interleaved rope rows, kv_b_proj split into
  w_uk / w_uv, stacked and shared experts, V3's fp32
  e_score_correction_bias, an MTP layer past num_hidden_layers) load
  bit-equal to JAX's tree, in fp32 and bf16, and an incomplete one
  raises JAX's error.
* The weight cache: DYN_WEIGHT_CACHE / DYN_WEIGHT_CACHE_DIR resolve as
  in JAX, the fingerprint is JAX's, a second load reads the cache,
  a changed checkpoint misses, clear drops the entry, and the port's
  entries and JAX's live side by side.
* TorchEngine(EngineConfig(model_path=...)) streams the greedy tokens
  JaxEngine streams from the same checkpoint (Qwen3, and Mixtral).
"""

import json
import logging
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models import weight_cache as jcache
from dynamo_tpu_torch.models import loader, weight_cache
from dynamo_tpu_torch.models.convert import params_from_numpy

pytestmark = pytest.mark.allow_slow_callbacks

HF = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
          num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
          vocab_size=256, rms_norm_eps=1e-5, rope_theta=10000.0,
          max_position_embeddings=512, eos_token_id=[2, 7])
VARIANTS = {
    "llama": dict(architectures=["LlamaForCausalLM"]),
    "llama-tied": dict(architectures=["LlamaForCausalLM"],
                       tie_word_embeddings=True),
    "qwen3": dict(architectures=["Qwen3ForCausalLM"]),
    "mistral-bf16": dict(architectures=["MistralForCausalLM"]),
    "mixtral": dict(architectures=["MixtralForCausalLM"],
                    num_local_experts=4, num_experts_per_tok=2),
}
_ST = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def write_safetensors(path, tensors, odd=False):
    """A safetensors file: the 8-byte little-endian header length, the
    JSON header (padded with spaces so the data starts 8-aligned, or at
    an odd offset with `odd`), then each tensor's bytes in order."""
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header).encode()
    hb += b" " * ((-(8 + len(hb))) % 8 + (1 if odd else 0))
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().data)


def hf_tensors(hf: dict, qk_norm: bool, dtype=torch.float32, seed=0):
    """HF-named tensors of a checkpoint of config `hf`, random."""
    rng = np.random.default_rng(seed)
    d, L = hf["hidden_size"], hf["num_hidden_layers"]
    hd, nh, nkv = hf["head_dim"], hf["num_attention_heads"], \
        hf["num_key_value_heads"]
    ffn, V = hf["intermediate_size"], hf["vocab_size"]

    def w(*shape, norm=False):
        a = (1 + 0.1 * rng.standard_normal(shape) if norm
             else rng.standard_normal(shape) / np.sqrt(shape[-1]))
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    out = {"model.embed_tokens.weight": w(V, d)}
    E = hf.get("num_local_experts", 0)
    for i in range(L):
        p = f"model.layers.{i}."
        out.update({
            p + "self_attn.q_proj.weight": w(nh * hd, d),
            p + "self_attn.k_proj.weight": w(nkv * hd, d),
            p + "self_attn.v_proj.weight": w(nkv * hd, d),
            p + "self_attn.o_proj.weight": w(d, nh * hd),
            p + "input_layernorm.weight": w(d, norm=True),
            p + "post_attention_layernorm.weight": w(d, norm=True),
        })
        if E:
            # Mixtral: the router, then one tensor per expert and kind
            moe = p + "block_sparse_moe."
            out[moe + "gate.weight"] = w(E, d)
            for e in range(E):
                out.update({moe + f"experts.{e}.w1.weight": w(ffn, d),
                            moe + f"experts.{e}.w3.weight": w(ffn, d),
                            moe + f"experts.{e}.w2.weight": w(d, ffn)})
        else:
            out.update({p + "mlp.gate_proj.weight": w(ffn, d),
                        p + "mlp.up_proj.weight": w(ffn, d),
                        p + "mlp.down_proj.weight": w(d, ffn)})
        if qk_norm:
            out[p + "self_attn.q_norm.weight"] = w(hd, norm=True)
            out[p + "self_attn.k_norm.weight"] = w(hd, norm=True)
    out["model.norm.weight"] = w(d, norm=True)
    if not hf.get("tie_word_embeddings"):
        out["lm_head.weight"] = w(V, d)
    return out


def write_checkpoint(path, variant="llama", tensors=None, odd=False):
    """config.json, two shards, tokenizer.json and a chat template."""
    os.makedirs(path, exist_ok=True)
    hf = {**HF, **VARIANTS[variant]}
    if tensors is None:
        tensors = hf_tensors(hf, variant == "qwen3",
                             torch.bfloat16 if "bf16" in variant
                             else torch.float32)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    names = list(tensors)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002"
                                       ".safetensors"),
                          {n: tensors[n] for n in part}, odd=odd)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump({"version": "1.0", "model": {"type": "BPE", "vocab": {},
                                               "merges": []}}, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"chat_template": "{% for m in messages %}{{ m.content }}"
                                    "{% endfor %}"}, f)
    return str(path)


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """Both packages' weight caches under this test's tmp_path."""
    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    return str(tmp_path / "wcache")


def _jax_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  params)


def _assert_trees_equal(got, want):
    """Two parameter trees of the port: same keys, dtypes and bits."""
    assert type(got) is type(want)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(got, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.is_contiguous()
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hf_config_equals_jax(variant, tmp_path):
    path = write_checkpoint(tmp_path / variant, variant)
    got = loader.load_hf_config(path, dtype=torch.float32)
    want = jloader.load_hf_config(path, dtype=jnp.float32)
    for field in ("name", "vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "head_dim", "ffn_dim", "rope_theta",
                  "rms_eps", "qk_norm", "tie_embeddings", "max_context",
                  "eos_token_ids", "n_experts", "experts_per_token"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.float32
    assert loader.load_hf_config(path).dtype == torch.bfloat16
    assert got.qk_norm is (variant == "qwen3")
    assert got.eos_token_ids == (2, 7)
    assert loader.load_chat_template(path) == jloader.load_chat_template(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_params_bit_equal_jax_load_params(variant, dtype, tmp_path):
    """The port's tree equals JAX's load_params output carried through
    models/convert.py (bf16 widened to fp32 and back: exact), bit for
    bit, in the engine's dtype: fp32 norms, the rest in `dtype`."""
    path = write_checkpoint(tmp_path / variant, variant)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcfg = loader.load_hf_config(path, dtype=tdt)
    jcfg = jloader.load_hf_config(path, dtype=jdt)
    got = loader.load_params(path, tcfg, device="cpu", host_cache=False)
    want = params_from_numpy(
        _jax_tree(jloader.load_params(path, jcfg, host_cache=False)), tcfg,
        device="cpu")
    _assert_trees_equal(got, want)
    assert ("lm_head" in got) is not tcfg.tie_embeddings
    assert got["layers"][1]["attn_norm"]["norm"].dtype == torch.float32
    assert got["layers"][0]["wq"].dtype == tdt
    assert ("q_norm" in got["layers"][0]) is tcfg.qk_norm


def test_untied_config_without_lm_head_uses_the_embedding(tmp_path):
    """A checkpoint that omits lm_head but does not declare tied
    embeddings: lm_head is the embedding transposed, as in JAX."""
    hf = {**HF, **VARIANTS["llama"]}
    tensors = hf_tensors(hf, False)
    del tensors["lm_head.weight"]
    path = write_checkpoint(tmp_path / "ck", "llama", tensors)
    cfg = loader.load_hf_config(path, dtype=torch.float32)
    got = loader.load_params(path, cfg, device="cpu", host_cache=False)
    want = params_from_numpy(_jax_tree(jloader.load_params(
        path, jloader.load_hf_config(path, dtype=jnp.float32),
        host_cache=False)), cfg, device="cpu")
    _assert_trees_equal(got, want)
    assert torch.equal(got["lm_head"], got["embedding"].T)


# DeepSeek V2 (V2-Lite's layout: no query bottleneck, softmax routing)
# and V3 (a q_lora_rank bottleneck, sigmoid routing with the choice
# bias, group-limited top k), at test widths with R != dr
DS_HF = dict(hidden_size=64, intermediate_size=128,
             moe_intermediate_size=32, num_attention_heads=4,
             num_hidden_layers=3, vocab_size=256, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
             first_k_dense_replace=1, rms_norm_eps=1e-6,
             rope_theta=10000.0, max_position_embeddings=512,
             eos_token_id=1, tie_word_embeddings=False)
DS_VARIANTS = {
    "v2": dict(architectures=["DeepseekV2ForCausalLM"], q_lora_rank=None,
               scoring_func="softmax", routed_scaling_factor=1.0,
               norm_topk_prob=False),
    "v3": dict(architectures=["DeepseekV3ForCausalLM"], q_lora_rank=24,
               n_group=2, topk_group=1, routed_scaling_factor=2.5),
}


def deepseek_tensors(hf: dict, dtype=torch.float32, seed=0, mtp=True):
    """HF-named tensors of a DeepSeek checkpoint of config `hf`, random,
    with a V3 router's e_score_correction_bias away from 0 and, with
    `mtp`, a multi-token-prediction layer at num_hidden_layers."""
    rng = np.random.default_rng(seed)
    d, L, V = hf["hidden_size"], hf["num_hidden_layers"], hf["vocab_size"]
    nh, R = hf["num_attention_heads"], hf["kv_lora_rank"]
    dn, dr, dv = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                  hf["v_head_dim"])
    qr, E = hf.get("q_lora_rank") or 0, hf["n_routed_experts"]
    f, ffn = hf["moe_intermediate_size"], hf["intermediate_size"]
    sf = hf["n_shared_experts"] * f
    v3 = hf["architectures"][0] == "DeepseekV3ForCausalLM"

    def w(*shape, norm=False):
        a = (1 + 0.1 * rng.standard_normal(shape) if norm
             else rng.standard_normal(shape) / np.sqrt(shape[-1]))
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    out = {"model.embed_tokens.weight": w(V, d)}
    for i in range(L + (1 if mtp else 0)):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        if qr:
            out.update({a + "q_a_proj.weight": w(qr, d),
                        a + "q_a_layernorm.weight": w(qr, norm=True),
                        a + "q_b_proj.weight": w(nh * (dn + dr), qr)})
        else:
            out[a + "q_proj.weight"] = w(nh * (dn + dr), d)
        out.update({a + "kv_a_proj_with_mqa.weight": w(R + dr, d),
                    a + "kv_a_layernorm.weight": w(R, norm=True),
                    a + "kv_b_proj.weight": w(nh * (dn + dv), R),
                    a + "o_proj.weight": w(d, nh * dv),
                    p + "input_layernorm.weight": w(d, norm=True),
                    p + "post_attention_layernorm.weight": w(d, norm=True)})
        if i < hf["first_k_dense_replace"]:
            out.update({p + "mlp.gate_proj.weight": w(ffn, d),
                        p + "mlp.up_proj.weight": w(ffn, d),
                        p + "mlp.down_proj.weight": w(d, ffn)})
            continue
        m = p + "mlp."
        out[m + "gate.weight"] = w(E, d)
        if v3:
            out[m + "gate.e_score_correction_bias"] = torch.from_numpy(
                rng.standard_normal(E).astype(np.float32) * 0.3)
        for e in range(E):
            out.update({m + f"experts.{e}.gate_proj.weight": w(f, d),
                        m + f"experts.{e}.up_proj.weight": w(f, d),
                        m + f"experts.{e}.down_proj.weight": w(d, f)})
        out.update({m + "shared_experts.gate_proj.weight": w(sf, d),
                    m + "shared_experts.up_proj.weight": w(sf, d),
                    m + "shared_experts.down_proj.weight": w(d, sf)})
        if i == L:
            # the MTP module's own tensors
            out[p + "eh_proj.weight"] = w(d, 2 * d)
    out["model.norm.weight"] = w(d, norm=True)
    out["lm_head.weight"] = w(V, d)
    return out


def write_deepseek_checkpoint(path, lineage="v2", tensors=None,
                              dtype=torch.float32):
    """A DeepSeek checkpoint of DS_HF and DS_VARIANTS[lineage]: its
    config.json and two shards (a layer's tensors split across them)."""
    os.makedirs(path, exist_ok=True)
    hf = {**DS_HF, **DS_VARIANTS[lineage]}
    if tensors is None:
        tensors = deepseek_tensors(hf, dtype)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    names = list(tensors)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002"
                                       ".safetensors"),
                          {n: tensors[n] for n in part})
    return str(path)


@pytest.mark.parametrize("lineage", sorted(DS_VARIANTS))
def test_deepseek_config_equals_jax(lineage, tmp_path):
    """A DeepSeek V2 or V3 config.json maps to JAX's DeepseekConfig,
    field by field (the dtype by name, the attention impl as each
    package names its plain one)."""
    import dataclasses

    from dynamo_tpu.models.deepseek import DeepseekConfig as JaxDs
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    path = write_deepseek_checkpoint(tmp_path / f"ds-{lineage}", lineage)
    got = loader.load_hf_config(path, dtype=torch.float32)
    want = jloader.load_hf_config(path, dtype=jnp.float32)
    assert isinstance(got, DeepseekConfig) and isinstance(want, JaxDs)
    g = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    w = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    assert (g.pop("dtype"), w.pop("dtype")) == (torch.float32, jnp.float32)
    assert (g.pop("attn_impl"), w.pop("attn_impl")) == ("torch", "jnp")
    assert g == w
    assert got.moe_scoring == ("sigmoid" if lineage == "v3" else "softmax")
    assert got.q_lora_rank == (24 if lineage == "v3" else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lineage", sorted(DS_VARIANTS))
def test_deepseek_params_bit_equal_jax_load_params(lineage, dtype,
                                                   tmp_path):
    """A DeepSeek V2 or V3 checkpoint with interleaved rope rows (the
    default), an MTP layer past num_hidden_layers and, for V3, a nonzero
    e_score_correction_bias: the port's tree equals JAX's load_params
    output carried through models/convert.py bit for bit, the norms and
    the choice bias fp32, the rest in `dtype`."""
    path = write_deepseek_checkpoint(tmp_path / f"ds-{lineage}", lineage)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcfg = loader.load_hf_config(path, dtype=tdt)
    jcfg = jloader.load_hf_config(path, dtype=jdt)
    got = loader.load_params(path, tcfg, device="cpu", host_cache=False)
    want = params_from_numpy(
        _jax_tree(jloader.load_params(path, jcfg, host_cache=False)), tcfg,
        device="cpu")
    _assert_trees_equal(got, want)
    assert len(got["layers"]) == 3          # the MTP layer is skipped
    lay = got["layers"][1]
    assert lay["moe_w_gate"].shape == (4, 64, 32)
    assert lay["shared"]["w_down"].shape == (32, 64)
    assert lay["w_uk"].shape == (4, 32, 16) and lay["w_uv"].dtype == tdt
    assert lay["kv_a_norm"]["norm"].dtype == torch.float32
    if lineage == "v3":
        bias = lay["moe_gate_bias"]
        assert bias.dtype == torch.float32 and bias.abs().min() > 0
        assert "wq_b" in lay and "wq" not in lay
    else:
        assert "moe_gate_bias" not in lay and "wq" in lay
    # the rope rows de-interleaved: kv_a's rows R + [0, 2, 4, 6, 1, 3, ...]
    raw = {n: t for n, t in deepseek_tensors(
        {**DS_HF, **DS_VARIANTS[lineage]}).items()}
    kv_a = raw["model.layers.0.self_attn.kv_a_proj_with_mqa.weight"]
    perm = [0, 2, 4, 6, 1, 3, 5, 7]
    assert torch.equal(got["layers"][0]["wkv_a"][:, 32:],
                       kv_a[32:][perm].T.to(tdt))


@pytest.mark.parametrize("fault", ["missing-expert", "missing-kv-b",
                                   "missing-bias", "unmapped"])
def test_incomplete_deepseek_raises_the_jax_error(fault, tmp_path):
    hf = {**DS_HF, **DS_VARIANTS["v3"]}
    tensors = deepseek_tensors(hf)
    p = "model.layers.2."
    if fault == "missing-expert":
        del tensors[p + "mlp.experts.3.down_proj.weight"]
    elif fault == "missing-kv-b":
        del tensors[p + "self_attn.kv_b_proj.weight"]
    elif fault == "missing-bias":
        del tensors[p + "mlp.gate.e_score_correction_bias"]
    else:
        tensors[p + "mlp.act.weight"] = torch.zeros(8)
    path = write_deepseek_checkpoint(tmp_path / "ck", "v3", tensors)
    with pytest.raises(ValueError) as want:
        jloader.load_params(path, jloader.load_hf_config(path),
                            host_cache=False)
    with pytest.raises(ValueError) as got:
        loader.load_params(path, device="cpu", host_cache=False)
    assert str(got.value) == str(want.value)


def test_deepseek_tree_goes_through_the_weight_cache(tmp_path, caplog):
    path = write_deepseek_checkpoint(tmp_path / "ck", "v3")
    cfg = loader.load_hf_config(path)
    first = loader.load_params(path, cfg, device="cpu")
    with caplog.at_level(logging.INFO):
        second = loader.load_params(path, cfg, device="cpu")
        assert "restored from host cache" in caplog.text
    _assert_trees_equal(second, first)
    assert second["layers"][2]["moe_gate_bias"].dtype == torch.float32


def test_mixtral_params_are_stacked_experts(tmp_path):
    """The Mixtral tree: no dense MLP, the router [d, E] and each kind's
    experts stacked [E, in, out] from the per-expert tensors."""
    hf = {**HF, **VARIANTS["mixtral"]}
    tensors = hf_tensors(hf, False)
    path = write_checkpoint(tmp_path / "ck", "mixtral", tensors)
    cfg = loader.load_hf_config(path, dtype=torch.float32)
    assert (cfg.n_experts, cfg.experts_per_token) == (4, 2)
    got = loader.load_params(path, cfg, device="cpu", host_cache=False)
    lay = got["layers"][1]
    assert "w_gate" not in lay
    assert lay["moe_gate"].shape == (64, 4)
    assert lay["moe_w_gate"].shape == (4, 64, 128)
    assert lay["moe_w_down"].shape == (4, 128, 64)
    moe = "model.layers.1.block_sparse_moe."
    for e in range(4):
        assert torch.equal(lay["moe_w_up"][e],
                           tensors[moe + f"experts.{e}.w3.weight"].T)
        assert torch.equal(lay["moe_w_down"][e],
                           tensors[moe + f"experts.{e}.w2.weight"].T)


@pytest.mark.parametrize("fault", ["missing-expert", "missing-router"])
def test_incomplete_mixtral_raises_the_jax_error(fault, tmp_path):
    hf = {**HF, **VARIANTS["mixtral"]}
    tensors = hf_tensors(hf, False)
    moe = "model.layers.1.block_sparse_moe."
    del tensors[moe + ("experts.2.w1.weight" if fault == "missing-expert"
                       else "gate.weight")]
    path = write_checkpoint(tmp_path / "ck", "mixtral", tensors)
    with pytest.raises(ValueError) as want:
        jloader.load_params(path, jloader.load_hf_config(path),
                            host_cache=False)
    with pytest.raises(ValueError) as got:
        loader.load_params(path, device="cpu", host_cache=False)
    assert str(got.value) == str(want.value)


def test_mixtral_stacks_through_the_weight_cache(tmp_path, caplog):
    path = write_checkpoint(tmp_path / "ck", "mixtral")
    cfg = loader.load_hf_config(path)
    first = loader.load_params(path, cfg, device="cpu")
    with caplog.at_level(logging.INFO):
        second = loader.load_params(path, cfg, device="cpu")
        assert "restored from host cache" in caplog.text
    _assert_trees_equal(second, first)
    assert second["layers"][0]["moe_w_gate"].dtype == torch.bfloat16


def test_unknown_architecture_raises_the_jax_error(tmp_path):
    path = tmp_path / "ck"
    os.makedirs(path)
    with open(path / "config.json", "w") as f:
        json.dump({**HF, "architectures": ["GPT2LMHeadModel"]}, f)
    with pytest.raises(ValueError) as want:
        jloader.load_hf_config(str(path))
    with pytest.raises(ValueError) as got:
        loader.load_hf_config(str(path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fault", ["unmapped", "unmapped-layer",
                                   "missing-layer", "missing-norm"])
def test_bad_checkpoints_raise_the_jax_errors(fault, tmp_path):
    hf = {**HF, **VARIANTS["llama"]}
    tensors = hf_tensors(hf, False)
    if fault == "unmapped":
        tensors["model.rotary_emb.inv_freq"] = torch.zeros(8)
    elif fault == "unmapped-layer":
        tensors["model.layers.0.mlp.act.weight"] = torch.zeros(8)
    elif fault == "missing-layer":
        tensors = {k: v for k, v in tensors.items()
                   if not k.startswith("model.layers.1.")}
    else:
        del tensors["model.norm.weight"]
    path = write_checkpoint(tmp_path / "ck", "llama", tensors)
    with pytest.raises(ValueError) as want:
        jloader.load_params(path, jloader.load_hf_config(path),
                            host_cache=False)
    with pytest.raises(ValueError) as got:
        loader.load_params(path, device="cpu", host_cache=False)
    assert str(got.value) == str(want.value)


def test_odd_offset_bf16_tensors_load_through_one_copy(tmp_path, caplog):
    """Every tensor of these bf16 shards starts at an odd byte offset:
    each is copied once into an aligned buffer (the log counts them),
    and the parameters equal those of the aligned files."""
    hf = {**HF, **VARIANTS["mistral-bf16"]}
    tensors = hf_tensors(hf, False, torch.bfloat16)
    aligned = write_checkpoint(tmp_path / "aligned", "mistral-bf16", tensors)
    odd = write_checkpoint(tmp_path / "odd", "mistral-bf16", tensors,
                           odd=True)
    shard = os.path.join(odd, "model-00001-of-00002.safetensors")
    with open(shard, "rb") as f:
        assert (8 + struct.unpack("<Q", f.read(8))[0]) % 2 == 1
    cfg = loader.load_hf_config(aligned)
    with caplog.at_level(logging.INFO, logger=loader.__name__):
        want = loader.load_params(aligned, cfg, device="cpu",
                                  host_cache=False)
        assert "0 unaligned tensors copied" in caplog.text
        caplog.clear()
        got = loader.load_params(odd, cfg, device="cpu", host_cache=False)
        assert f"{len(tensors)} unaligned tensors copied" in caplog.text
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("env", [{}, {"DYN_WEIGHT_CACHE": "0"},
                                 {"DYN_WEIGHT_CACHE": "off",
                                  "DYN_WEIGHT_CACHE_DIR": "/x"},
                                 {"DYN_WEIGHT_CACHE_DIR": "/x/y"}])
def test_default_cache_dir_follows_the_jax_rules(env, monkeypatch):
    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.delenv("DYN_WEIGHT_CACHE_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert weight_cache.default_cache_dir() == jcache.default_cache_dir()


def test_weight_cache_write_read_stale_clear(tmp_path, _cache_dir, caplog):
    path = write_checkpoint(tmp_path / "ck", "qwen3")
    cfg = loader.load_hf_config(path, dtype=torch.float32)
    assert weight_cache.checkpoint_fingerprint(path) == \
        jcache.checkpoint_fingerprint(path)
    with caplog.at_level(logging.INFO):
        first = loader.load_params(path, cfg, device="cpu")
        assert "from disk" in caplog.text
        caplog.clear()
        second = loader.load_params(path, cfg, device="cpu")
        assert "restored from host cache" in caplog.text
        assert "from disk" not in caplog.text
    _assert_trees_equal(second, first)
    entry = weight_cache._entry_dir(_cache_dir, path)
    assert os.path.isfile(os.path.join(entry, "index.json"))
    with open(os.path.join(entry, "index.json")) as f:
        index = json.load(f)
    assert index["fingerprint"] == weight_cache.checkpoint_fingerprint(path)
    assert index["tensors"]["layers.1.q_norm.norm"]["dtype"] == "float32"
    # the JAX package's entry for the same checkpoint lives beside it
    jparams = jloader.load_params(path, jloader.load_hf_config(path))
    assert jcache.read_cache(_cache_dir, path) is not None
    assert sorted(os.listdir(_cache_dir)) == sorted(
        [weight_cache.SUBDIR, os.path.basename(jcache._entry_dir(
            _cache_dir, path))])
    _assert_trees_equal(weight_cache.read_cache(_cache_dir, path, "cpu"),
                        first)
    assert jparams["layers"][0]["wq"].dtype == jnp.bfloat16
    # a changed checkpoint misses the cache
    cfg_json = os.path.join(path, "config.json")
    st = os.stat(cfg_json)
    os.utime(cfg_json, (st.st_atime, st.st_mtime + 10))
    assert weight_cache.read_cache(_cache_dir, path, "cpu") is None
    # clear: the entry goes, the JAX entry stays
    loader.load_params(path, cfg, device="cpu")
    weight_cache.clear_cache(_cache_dir, path)
    assert not os.path.exists(entry)
    loader.load_params(path, cfg, device="cpu")
    weight_cache.clear_cache(_cache_dir)
    assert not os.path.exists(os.path.join(_cache_dir, weight_cache.SUBDIR))
    assert os.path.isfile(os.path.join(jcache._entry_dir(_cache_dir, path),
                                       "index.json"))


async def test_engine_serves_the_checkpoint_like_the_jax_engine(tmp_path):
    """EngineConfig(model_path=...): the port's engine loads the
    checkpoint and streams JaxEngine's greedy tokens on it, fp32."""
    await _serve_like_jax(tmp_path, "qwen3")


async def test_engine_serves_a_mixtral_checkpoint_like_the_jax_engine(
        tmp_path):
    """The same with a Mixtral checkpoint (dense dispatch, JAX's
    default): the experts load stacked and route as JAX's."""
    await _serve_like_jax(tmp_path, "mixtral")


async def _serve_like_jax(tmp_path, variant):
    from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine import JaxEngine
    from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
    from dynamo_tpu.protocols import SamplingOptions as JaxSampling
    from dynamo_tpu.protocols import StopConditions as JaxStop
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.protocols import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    path = write_checkpoint(tmp_path / "ck", variant)
    common = dict(model_path=path, block_size=4, num_blocks=64,
                  max_blocks_per_seq=16, max_num_seqs=2,
                  prefill_buckets=(8, 16, 32))
    te = TorchEngine(EngineConfig(
        model_config=loader.load_hf_config(path, dtype=torch.float32),
        **common), device="cpu")
    je = JaxEngine(JaxEngineConfig(
        model_config=jloader.load_hf_config(path, dtype=jnp.float32),
        **common))
    assert te.config.served_name == "ck" == je.config.served_name
    assert te.eos_ids == frozenset({2, 7})
    prompts = [[5, 9, 13, 2, 7, 11, 3, 1], list(range(20, 31))]
    res = {}
    for name, eng, (R, S, T) in (
            ("torch", te, (PreprocessedRequest, SamplingOptions,
                           StopConditions)),
            ("jax", je, (JaxRequest, JaxSampling, JaxStop))):
        res[name] = []
        try:
            for i, p in enumerate(prompts):
                toks = []
                async for out in eng.generate(R(
                        token_ids=p, request_id=f"{name}{i}",
                        sampling=S(temperature=0.0),
                        stop=T(max_tokens=12, ignore_eos=True))):
                    toks.extend(out.token_ids)
                res[name].append(toks)
        finally:
            await eng.close()
    assert res["torch"] == res["jax"]
    assert all(len(t) == 12 for t in res["torch"])
