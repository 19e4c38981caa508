"""HF checkpoint loading: config.json + *.safetensors -> the port's params.

The counterpart of dynamo_tpu/models/loader.py for the Llama lineage
(Llama, Mistral, Qwen2, Qwen3 with its per-head q/k norms) and Mixtral
(its router and per-expert weights stacked into [E, ...] arrays).  The
DeepSeek (MLA) architectures raise NotImplementedError: they come with
ROADMAP.md Queue 1 item 9.

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
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .llama import LlamaConfig

logger = logging.getLogger(__name__)

_ARCHS = {
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "MixtralForCausalLM": {},  # experts from config.json
    "Qwen2ForCausalLM": {},
    "Qwen3ForCausalLM": {"qk_norm": True},
}
# the MLA family (models/deepseek.py in the JAX package)
_DS_ARCHS = ("DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM")

# safetensors dtype names the loader reads
_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
           "F32": torch.float32}


def load_hf_config(model_path: str,
                   dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """config.json -> LlamaConfig, the fields of the JAX loader's."""
    with open(os.path.join(model_path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if arch in _DS_ARCHS:
        raise NotImplementedError(
            f"{arch}: the MLA (DeepSeek) family is not ported to "
            "dynamo_tpu_torch yet (ROADMAP.md Queue 1 item 9: MLA)")
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


def load_params(model_path: str, cfg: Optional[LlamaConfig] = None,
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
    logger.info("loaded %s from disk to %s: %d tensors, %.3f GB in %.2f s; "
                "%d unaligned tensors copied", model_path, dev,
                stats["tensors"], stats["bytes"] / 1e9,
                time.perf_counter() - t0, stats["copies"])
    if cache_dir is not None:
        write_cache(cache_dir, model_path, params)
    return params
