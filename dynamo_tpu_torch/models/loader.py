"""HF checkpoint loading: config.json + *.safetensors -> the port's params.

The counterpart of dynamo_tpu/models/loader.py for the Llama lineage
(Llama, Mistral, Qwen2, Qwen3 with its per-head q/k norms), Mixtral
(its router and per-expert weights stacked into [E, ...] arrays) and
the DeepSeek V2/V3 (MLA) architectures (models/deepseek.py; the mapping
is `_load_deepseek_params`'s).

The safetensors files are read with the standard library and torch
alone (a GPU host need have neither `safetensors` nor `ml_dtypes`, and
numpy has no bfloat16): each file's 8-byte
little-endian header length and JSON header are parsed, the file is
mapped (mmap, copy-on-write so torch sees a writable buffer it never
writes), and each tensor is a `torch.frombuffer` view of its bytes, in
file order.  A tensor whose bytes do not start at a multiple of its
element size is copied once into an aligned buffer (counted in the log).

Each tensor is then cast to its parameter dtype (fp32 for norms, the
model's dtype for the rest), transposed where the JAX tree stores
[in, out] (HF nn.Linear stores [out, in]), made contiguous in host
memory and copied to the device: on CUDA through one pinned staging
buffer, so host memory holds one tensor at a time beyond the map.

Name mapping (HF -> the JAX package's tree, which the port shares):

    model.embed_tokens.weight              embedding        [vocab, d]
    lm_head.weight                         lm_head          [d, vocab] (T)
    model.norm.weight                      final_norm.norm
    ...layers.N.self_attn.{q,k,v,o}_proj   layers[N].wq/wk/wv/wo (T)
    ...layers.N.self_attn.{q,k}_norm       layers[N].q_norm/k_norm (Qwen3)
    ...layers.N.input_layernorm            layers[N].attn_norm.norm
    ...layers.N.post_attention_layernorm   layers[N].mlp_norm.norm
    ...layers.N.mlp.{gate,up,down}_proj    layers[N].w_gate/w_up/w_down (T)
    ...block_sparse_moe.gate               layers[N].moe_gate [d, E] (T)
    ...block_sparse_moe.experts.E.w1/w3/w2 layers[N].moe_w_gate/up/down
                                           [E, in, out], expert E's (T)

Mixtral keeps one tensor per expert; `_ExpertStage` streams each into
one preallocated host stack per (layer, kind) and places the stack when
its last expert arrives, so host memory holds one stack per kind in
flight, not E copies and a stack.

With the weight cache on (models/weight_cache.py, on by default), a
second load of the same checkpoint reads the finished tensors from host
RAM instead.
"""

from __future__ import annotations

import json
import logging
import math
import mmap
import os
import re
import struct
import time
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from .deepseek import DeepseekConfig
from .llama import LlamaConfig

logger = logging.getLogger(__name__)

_ARCHS = {
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "MixtralForCausalLM": {},  # experts from config.json
    "Qwen2ForCausalLM": {},
    "Qwen3ForCausalLM": {"qk_norm": True},
}
# the MLA family (models/deepseek.py): V3 routes by sigmoid plus the
# choice bias, V2 declares its scoring_func in config.json
_DS_ARCHS = {"DeepseekV2ForCausalLM": "v2", "DeepseekV3ForCausalLM": "v3"}

# safetensors dtype names the loader reads
_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
           "F32": torch.float32}


def _load_deepseek_config(hf: dict, lineage: str, name: str,
                          dtype: torch.dtype) -> DeepseekConfig:
    """A DeepSeek config.json -> DeepseekConfig, the JAX loader's fields
    and defaults (V3: sigmoid scoring, renormalized top k)."""
    eos = hf.get("eos_token_id", 2)
    eos_ids = tuple(int(e) for e in eos) if isinstance(eos, list) else (
        (int(eos),) if eos is not None else (2,))
    scoring = ("sigmoid" if lineage == "v3"
               else hf.get("scoring_func", "softmax"))
    return DeepseekConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        q_lora_rank=int(hf.get("q_lora_rank") or 0),
        kv_lora_rank=int(hf["kv_lora_rank"]),
        qk_nope_head_dim=int(hf["qk_nope_head_dim"]),
        qk_rope_head_dim=int(hf["qk_rope_head_dim"]),
        v_head_dim=int(hf["v_head_dim"]),
        ffn_dim=hf["intermediate_size"],
        moe_ffn_dim=int(hf.get("moe_intermediate_size") or 0),
        n_experts=int(hf.get("n_routed_experts") or 0),
        experts_per_token=int(hf.get("num_experts_per_tok") or 2),
        n_shared_experts=int(hf.get("n_shared_experts") or 0),
        first_k_dense=int(hf.get("first_k_dense_replace") or 0),
        routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
        moe_scoring=scoring,
        norm_topk_prob=bool(hf.get("norm_topk_prob", lineage == "v3")),
        n_group=int(hf.get("n_group") or 1),
        topk_group=int(hf.get("topk_group") or 1),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_context=int(hf.get("max_position_embeddings", 8192)),
        dtype=dtype,
        eos_token_ids=eos_ids,
    )


def load_hf_config(model_path: str, dtype: torch.dtype = torch.bfloat16
                   ) -> Union[LlamaConfig, DeepseekConfig]:
    """config.json -> LlamaConfig or DeepseekConfig by architecture, the
    fields of the JAX loader's."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if arch in _DS_ARCHS:
        name = os.path.basename(os.path.abspath(model_path)) \
            or hf.get("model_type", "hf-model")
        return _load_deepseek_config(hf, _DS_ARCHS[arch], name, dtype)
    if arch not in _ARCHS:
        raise ValueError(
            f"unsupported architecture {arch!r}; have "
            f"{sorted(_ARCHS) + sorted(_DS_ARCHS)}")
    n_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // n_heads
    eos = hf.get("eos_token_id", 2)
    eos_ids = tuple(int(e) for e in eos) if isinstance(eos, list) else (
        (int(eos),) if eos is not None else ())
    return LlamaConfig(
        name=os.path.basename(os.path.abspath(model_path)) or hf.get(
            "model_type", "hf-model"),
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        head_dim=head_dim,
        ffn_dim=hf["intermediate_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        max_context=int(hf.get("max_position_embeddings", 8192)),
        dtype=dtype,
        eos_token_ids=eos_ids or (2,),
        n_experts=int(hf.get("num_local_experts", 0)),
        experts_per_token=int(hf.get("num_experts_per_tok", 2)),
        **_ARCHS[arch],
    )


def load_chat_template(model_path: str) -> Optional[str]:
    """The checkpoint's chat template (the standalone chat_template.jinja,
    else tokenizer_config.json's), if any."""
    jinja = os.path.join(model_path, "chat_template.jinja")
    if os.path.exists(jinja):
        with open(jinja) as f:
            return f.read()
    tc = os.path.join(model_path, "tokenizer_config.json")
    try:
        with open(tc) as f:
            tmpl = json.load(f).get("chat_template")
        return tmpl if isinstance(tmpl, str) else None
    except (OSError, json.JSONDecodeError):
        return None


_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# HF suffix -> (our key, transpose?)
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

_NORM_KEYS = {"attn_norm", "mlp_norm", "q_norm", "k_norm"}

# Mixtral's MoE layer tensors: the router, and one tensor per expert
# (w1 = gate, w3 = up, w2 = down; HF Linear [out, in], transposed like
# the dense maps), stacked [n_experts, ...] in the tree
_MOE_GATE = "block_sparse_moe.gate.weight"
_MOE_EXPERT_RE = re.compile(
    r"^block_sparse_moe\.experts\.(\d+)\.(w1|w2|w3)\.weight$")
_MOE_W_MAP = {"w1": "moe_w_gate", "w3": "moe_w_up", "w2": "moe_w_down"}
_MOE_KEYS = {"moe_gate", "moe_w_gate", "moe_w_up", "moe_w_down"}
_DENSE_MLP = {"mlp.gate_proj.weight", "mlp.up_proj.weight",
              "mlp.down_proj.weight"}


# -- reading ----------------------------------------------------------------


def map_file(path: str):
    """The whole file mapped copy-on-write: a writable buffer for
    torch.frombuffer that is never written, so nothing is copied."""
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def tensor_view(buf, dtype: torch.dtype, shape, offset: int,
                stats: Dict[str, int]) -> torch.Tensor:
    """The tensor of `shape` and `dtype` whose bytes start at `offset` of
    `buf`: a view of the buffer, or, where the offset is not a multiple
    of the element size, of a copy of its bytes (counted in
    stats["copies"])."""
    count = math.prod(shape)
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    size = dtype.itemsize
    if offset % size:
        stats["copies"] += 1
        t = torch.frombuffer(bytearray(buf[offset:offset + count * size]),
                             dtype=dtype)
    else:
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    return t.view(shape)


def _iter_safetensors(model_path: str, stats: Dict[str, int]
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of every *.safetensors file under
    `model_path`, files by name (iter_safetensors_file)."""
    files = sorted(f for f in os.listdir(model_path)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {model_path}")
    for fname in files:
        yield from iter_safetensors_file(os.path.join(model_path, fname),
                                         stats)


def iter_safetensors_file(path: str, stats: Dict[str, int]
                          ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of the safetensors file `path`, by
    offset; each tensor is a view of the file's map (tensor_view), valid
    until the caller drops it.  A file is an 8-byte little-endian header
    length, that many bytes of JSON header, then the tensors' bytes.
    `stats` counts "tensors", "bytes" and "copies"."""
    fname = os.path.basename(path)
    buf = map_file(path)
    (n,) = struct.unpack_from("<Q", buf)
    header = json.loads(buf[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    for name, meta in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(
                f"{fname}: tensor {name!r} has dtype {meta['dtype']!r}; "
                f"the loader reads {sorted(_DTYPES)}")
        begin, end = meta["data_offsets"]
        if end - begin != math.prod(meta["shape"]) * dtype.itemsize:
            raise ValueError(f"{fname}: tensor {name!r} spans "
                             f"{end - begin} bytes, not its shape's")
        stats["tensors"] += 1
        stats["bytes"] += end - begin
        yield name, tensor_view(buf, dtype, meta["shape"], base + begin,
                                stats)


class _ExpertStage:
    """Streams per-expert tensors into ONE preallocated host stack
    [E, ...] in `dtype` per (layer, kind), handing it to
    `sink(li, key, stack)` when every expert has arrived: host memory
    holds one stack per kind in flight, not E copies and a stack."""

    def __init__(self, n_experts: int, dtype: torch.dtype, sink):
        self.n_experts = n_experts
        self.dtype = dtype
        self.sink = sink
        self._stage: Dict[int, Dict[str, Any]] = {}

    def feed(self, li: int, e: int, key: str, t: torch.Tensor) -> None:
        stage = self._stage.setdefault(li, {})
        if key not in stage:
            stage[key] = (torch.empty((self.n_experts, *t.shape),
                                      dtype=self.dtype), set())
        buf, got = stage[key]
        buf[e].copy_(t)
        got.add(e)
        if len(got) == self.n_experts:
            del stage[key]
            self.sink(li, key, buf)

    def pending(self):
        """(layer, unfinished kinds) pairs, for the completeness check."""
        return [(li, sorted(parts)) for li, parts in self._stage.items()
                if parts]


class Placer:
    """Host tensors -> contiguous tensors of a given dtype on the device.
    On the CPU a fresh tensor (never a view of a file's map).  On CUDA the
    cast and transpose are written into one pinned staging buffer, copied
    to the device asynchronously, and the buffer is reused once that copy
    has run: host memory holds one tensor at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    def put(self, src: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.empty(src.shape, dtype=dtype).copy_(src)
        n = src.numel() * dtype.itemsize
        if self._copied is not None:
            self._copied.synchronize()
        if self._buf is None or self._buf.numel() < n:
            self._buf = None
            self._buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host = self._buf[:n].view(dtype).view(src.shape)
        host.copy_(src)
        out = torch.empty(src.shape, dtype=dtype, device=self.device)
        out.copy_(host, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return out

    def finish(self) -> None:
        """Wait for the last copy; the staging buffer is released."""
        if self._copied is not None:
            self._copied.synchronize()
        self._buf = self._copied = None


def load_params(model_path: str,
                cfg: Optional[Union[LlamaConfig, DeepseekConfig]] = None,
                device: DeviceLike = "cuda",
                host_cache: bool = True) -> Dict[str, Any]:
    """Load a HF checkpoint into the port's parameter tree on `device`
    (CUDA unless the caller asks for the CPU).  `cfg` defaults to the
    checkpoint's (load_hf_config); its dtype is the weights'.

    host_cache: read and fill the host-RAM weight cache
    (models/weight_cache.py), so a restarted worker skips the disk read,
    the parse and every transform.  DYN_WEIGHT_CACHE=0 disables it."""
    from .weight_cache import default_cache_dir, read_cache, write_cache

    dev = resolve_device(device)
    cache_dir = default_cache_dir() if host_cache else None
    if cache_dir is not None:
        cached = read_cache(cache_dir, model_path, device=dev)
        if cached is not None:
            return cached
    cfg = cfg or load_hf_config(model_path)
    t0 = time.perf_counter()
    placer = Placer(dev)
    stats = {"tensors": 0, "bytes": 0, "copies": 0}
    load = (_load_deepseek_params if isinstance(cfg, DeepseekConfig)
            else _load_llama_params)
    params = load(model_path, cfg, placer, stats, dev)
    logger.info("loaded %s from disk to %s: %d tensors, %.3f GB in %.2f s; "
                "%d unaligned tensors copied", model_path, dev,
                stats["tensors"], stats["bytes"] / 1e9,
                time.perf_counter() - t0, stats["copies"])
    if cache_dir is not None:
        write_cache(cache_dir, model_path, params)
    return params


def _load_llama_params(model_path: str, cfg: LlamaConfig, placer: Placer,
                       stats: Dict[str, int],
                       dev: torch.device) -> Dict[str, Any]:
    """The Llama lineage's and Mixtral's tensors -> the llama.py tree."""
    params: Dict[str, Any] = {
        "layers": [dict() for _ in range(cfg.n_layers)]}

    def place_stack(li: int, key: str, stack: torch.Tensor) -> None:
        # on the CPU the stack is already a fresh tensor of the dtype
        params["layers"][li][key] = (stack if dev.type == "cpu"
                                     else placer.put(stack, cfg.dtype))

    stage = _ExpertStage(cfg.n_experts, cfg.dtype, place_stack)
    for name, tensor in _iter_safetensors(model_path, stats):
        m = _LAYER_RE.match(name)
        if m:
            li, suffix = int(m.group(1)), m.group(2)
            em = _MOE_EXPERT_RE.match(suffix)
            if em:
                stage.feed(li, int(em.group(1)), _MOE_W_MAP[em.group(2)],
                           tensor.T)
                continue
            if suffix == _MOE_GATE:
                params["layers"][li]["moe_gate"] = placer.put(tensor.T,
                                                              cfg.dtype)
                continue
            if suffix not in _LAYER_MAP:
                raise ValueError(f"unmapped layer tensor {name!r}")
            key, transpose = _LAYER_MAP[suffix]
            t = tensor.T if transpose else tensor
            if key in _NORM_KEYS:
                params["layers"][li][key] = {
                    "norm": placer.put(t, torch.float32)}
            else:
                params["layers"][li][key] = placer.put(t, cfg.dtype)
        elif name == "model.embed_tokens.weight":
            params["embedding"] = placer.put(tensor, cfg.dtype)
        elif name == "lm_head.weight":
            params["lm_head"] = placer.put(tensor.T, cfg.dtype)
        elif name == "model.norm.weight":
            params["final_norm"] = {"norm": placer.put(tensor, torch.float32)}
        else:
            raise ValueError(f"unmapped tensor {name!r}")
    placer.finish()

    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    elif "lm_head" not in params and "embedding" in params:
        # some tied checkpoints omit lm_head but don't set the flag
        params["lm_head"] = params["embedding"].T.contiguous()

    missing = []
    if "embedding" not in params:
        missing.append("model.embed_tokens.weight")
    if "final_norm" not in params:
        missing.append("model.norm.weight")
    want = set(_LAYER_MAP)
    if not cfg.qk_norm:
        want -= {"self_attn.q_norm.weight", "self_attn.k_norm.weight"}
    if cfg.n_experts > 0:
        # the routed MLP replaces the dense one: the router and three
        # expert stacks instead of the three dense projections
        want = (want - _DENSE_MLP) | _MOE_KEYS
    missing.extend(f"model.layers.{li} expert tensors {parts}"
                   for li, parts in stage.pending())
    for li, layer in enumerate(params["layers"]):
        got = len(layer)
        if got != len(want):
            missing.append(f"model.layers.{li} ({got}/{len(want)} tensors)")
    if missing:
        raise ValueError(f"incomplete checkpoint {model_path}: missing "
                         f"{missing[:5]}")
    return params


def _deinterleave_rope_rows(w: torch.Tensor, rope_dim: int) -> torch.Tensor:
    """The rope-row block [rope_dim, ...] of a DeepSeek weight with its
    rows de-interleaved (even rows, then odd): HF checkpoints store them
    interleaved and de-interleave each head at run time; permuting the
    rows once at load time lets the half-split rope (llama.py) apply
    directly, as the JAX loader does."""
    idx = torch.cat([torch.arange(0, rope_dim, 2),
                     torch.arange(1, rope_dim, 2)])
    return w[idx]


_DS_EXPERT_RE = re.compile(
    r"^mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight$")
_DS_SHARED_RE = re.compile(
    r"^mlp\.shared_experts\.(gate_proj|up_proj|down_proj)\.weight$")
_DS_W_MAP = {"gate_proj": "w_gate", "up_proj": "w_up",
             "down_proj": "w_down"}
# HF suffix -> our norm key (fp32 {"norm": ...})
_DS_NORMS = {"input_layernorm.weight": "attn_norm",
             "post_attention_layernorm.weight": "mlp_norm",
             "self_attn.kv_a_layernorm.weight": "kv_a_norm",
             "self_attn.q_a_layernorm.weight": "q_a_norm"}
# HF suffix -> our key of a plain transposed matrix
_DS_LINEAR = {"self_attn.q_a_proj.weight": "wq_a",
              "self_attn.o_proj.weight": "wo",
              "mlp.gate.weight": "moe_gate",
              "mlp.gate_proj.weight": "w_gate",
              "mlp.up_proj.weight": "w_up",
              "mlp.down_proj.weight": "w_down"}


def _load_deepseek_params(model_path: str, cfg: DeepseekConfig,
                          placer: Placer, stats: Dict[str, int],
                          dev: torch.device) -> Dict[str, Any]:
    """A DeepSeek V2/V3 checkpoint -> the deepseek.py tree, the JAX
    loader's mapping (HF Linear is [out, in]; the tree transposes):

        self_attn.q_proj | q_a_proj, q_a_layernorm, q_b_proj
                                       wq | wq_a, q_a_norm, wq_b
                                       (each head's rope rows
                                       de-interleaved)
        self_attn.kv_a_proj_with_mqa   wkv_a (rope rows de-interleaved)
        self_attn.kv_a_layernorm       kv_a_norm
        self_attn.kv_b_proj            w_uk [nh, R, dn] + w_uv [nh, R, dv]
        self_attn.o_proj               wo
        mlp.gate.weight                moe_gate
        mlp.gate.e_score_correction_bias   moe_gate_bias (fp32)
        mlp.experts.E.{gate,up,down}_proj  moe_w_* (stacked [E, ...])
        mlp.shared_experts.{gate,up,down}_proj  shared.w_*

    The de-interleave applies when config.json's rope_interleave is
    true (its default).  Layers at or past num_hidden_layers (V3's
    multi-token-prediction module) are skipped."""
    with open(os.path.join(model_path, "config.json")) as f:
        interleaved = bool(json.load(f).get("rope_interleave", True))
    R, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv, nh = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.n_heads

    def perm_q(t: torch.Tensor) -> torch.Tensor:
        """q/q_b rows [nh * (dn + dr), in] with each head's rope block
        de-interleaved."""
        if not interleaved:
            return t
        t = t.reshape(nh, dn + dr, -1)
        rope_rows = _deinterleave_rope_rows(t[:, dn:].transpose(0, 1), dr)
        return torch.cat([t[:, :dn], rope_rows.transpose(0, 1)],
                         dim=1).reshape(nh * (dn + dr), -1)

    params: Dict[str, Any] = {
        "layers": [dict() for _ in range(cfg.n_layers)]}

    def place_stack(li: int, key: str, stack: torch.Tensor) -> None:
        params["layers"][li][key] = (stack if dev.type == "cpu"
                                     else placer.put(stack, cfg.dtype))

    stage = _ExpertStage(cfg.n_experts, cfg.dtype, place_stack)
    for name, tensor in _iter_safetensors(model_path, stats):
        m = _LAYER_RE.match(name)
        if m:
            li, suffix = int(m.group(1)), m.group(2)
            if li >= cfg.n_layers:
                # the multi-token-prediction module of V3/R1 checkpoints
                # (layer num_hidden_layers) is no part of serving
                continue
            layer = params["layers"][li]
            em = _DS_EXPERT_RE.match(suffix)
            sm = _DS_SHARED_RE.match(suffix)
            if em:
                stage.feed(li, int(em.group(1)),
                           "moe_" + _DS_W_MAP[em.group(2)], tensor.T)
            elif sm:
                layer.setdefault("shared", {})[_DS_W_MAP[sm.group(1)]] = \
                    placer.put(tensor.T, cfg.dtype)
            elif suffix in _DS_NORMS:
                layer[_DS_NORMS[suffix]] = {
                    "norm": placer.put(tensor, torch.float32)}
            elif suffix in _DS_LINEAR:
                layer[_DS_LINEAR[suffix]] = placer.put(tensor.T, cfg.dtype)
            elif suffix == "mlp.gate.e_score_correction_bias":
                layer["moe_gate_bias"] = placer.put(tensor, torch.float32)
            elif suffix == "self_attn.q_proj.weight":
                layer["wq"] = placer.put(perm_q(tensor).T, cfg.dtype)
            elif suffix == "self_attn.q_b_proj.weight":
                layer["wq_b"] = placer.put(perm_q(tensor).T, cfg.dtype)
            elif suffix == "self_attn.kv_a_proj_with_mqa.weight":
                t = tensor
                if interleaved:
                    t = torch.cat([t[:R], _deinterleave_rope_rows(t[R:], dr)])
                layer["wkv_a"] = placer.put(t.T, cfg.dtype)
            elif suffix == "self_attn.kv_b_proj.weight":
                # [nh * (dn + dv), R] -> per-head up-projections [nh, R, *]
                t = tensor.reshape(nh, dn + dv, R)
                layer["w_uk"] = placer.put(t[:, :dn].transpose(1, 2),
                                           cfg.dtype)
                layer["w_uv"] = placer.put(t[:, dn:].transpose(1, 2),
                                           cfg.dtype)
            else:
                raise ValueError(f"unmapped deepseek tensor {name!r}")
        elif name == "model.embed_tokens.weight":
            params["embedding"] = placer.put(tensor, cfg.dtype)
        elif name == "lm_head.weight":
            params["lm_head"] = placer.put(tensor.T, cfg.dtype)
        elif name == "model.norm.weight":
            params["final_norm"] = {"norm": placer.put(tensor, torch.float32)}
        else:
            raise ValueError(f"unmapped deepseek tensor {name!r}")
    placer.finish()

    if cfg.tie_embeddings:
        params.pop("lm_head", None)
    elif "lm_head" not in params and "embedding" in params:
        params["lm_head"] = params["embedding"].T.contiguous()

    # completeness: each layer's tensor count from the config, then the
    # unfinished expert stacks (the JAX loader's order and texts)
    missing = [k for k in ("embedding", "final_norm") if k not in params]
    for li, layer in enumerate(params["layers"]):
        want = 7  # attn_norm, mlp_norm, wkv_a, kv_a_norm, w_uk, w_uv, wo
        want += 3 if cfg.q_lora_rank > 0 else 1
        if cfg._moe_layer(li):
            want += 4 + (1 if cfg.moe_scoring == "sigmoid" else 0) \
                + (1 if cfg.n_shared_experts > 0 else 0)
        else:
            want += 3
        if len(layer) != want:
            missing.append(
                f"model.layers.{li} ({len(layer)}/{want} tensors)")
    missing.extend(f"model.layers.{li} expert tensors {parts}"
                   for li, parts in stage.pending())
    if missing:
        raise ValueError(f"incomplete checkpoint {model_path}: missing "
                         f"{missing[:5]}")
    return params
