"""Mini-profiler: closed-loop sweep that measures an engine's latency
surface, producing the perf profile the SLA planner plans against.

A copy of dynamo_tpu/profiler/profile.py.  The sweep drives any object
with the engine `generate(PreprocessedRequest) -> AsyncIterator
[LLMEngineOutput]` contract: the port's TorchEngine on the card (its
prefills run K3, its decode steps K1).  For each (ISL, concurrency) grid
point it runs a closed loop of `concurrency` requests and records
first-token and inter-token latencies.  The profile's JSON is the JAX
profiler's, so a profile taken by either package plans in the other.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

from ..protocols import PreprocessedRequest, SamplingOptions, StopConditions
from ..runtime.metrics import percentile


def _pctl(xs: List[float], q: float) -> float:
    return percentile(xs, q * 100.0)


@dataclass
class PerfPoint:
    """One grid point: `concurrency` closed-loop requests of `isl`
    prompt tokens / `osl` output tokens each."""

    isl: int
    osl: int
    concurrency: int
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    itl_mean_s: float = 0.0
    itl_p95_s: float = 0.0
    req_per_s: float = 0.0
    output_tok_per_s: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PerfPoint":
        return cls(**d)


@dataclass
class PerfProfile:
    """A sweep's worth of PerfPoints plus identifying metadata,
    serialized as JSON so a profile taken on one machine bootstraps a
    planner running anywhere."""

    model_name: str = ""
    points: List[PerfPoint] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "model_name": self.model_name,
            "meta": self.meta,
            "points": [p.to_dict() for p in self.points],
        }, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "PerfProfile":
        d = json.loads(s)
        return cls(model_name=d.get("model_name", ""),
                   meta=d.get("meta", {}),
                   points=[PerfPoint.from_dict(p)
                           for p in d.get("points", [])])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "PerfProfile":
        with open(path) as f:
            return cls.from_json(f.read())


async def _measure_point(engine, isl: int, osl: int, concurrency: int,
                         *, rounds: int, token_base: int) -> PerfPoint:
    """Closed loop: each of `concurrency` workers issues `rounds`
    sequential requests; latencies are pooled across workers."""
    ttfts: List[float] = []
    itls: List[float] = []
    n_done = 0
    t_start = time.monotonic()

    async def one_worker(w: int) -> None:
        nonlocal n_done
        for r in range(rounds):
            # unique prompts: defeat the prefix cache so prefill cost is
            # real (a profile with 100% cache hits underestimates TTFT)
            base = token_base + (w * rounds + r) * (isl + 1)
            req = PreprocessedRequest(
                token_ids=[3 + (base + i) % 30000 for i in range(isl)],
                request_id=f"prof-{w}-{r}-{base}",
                stop=StopConditions(max_tokens=osl, ignore_eos=True),
                sampling=SamplingOptions(temperature=0.0),
            )
            t0 = time.monotonic()
            t_prev: Optional[float] = None
            async for out in engine.generate(req):
                now = time.monotonic()
                if out.token_ids:
                    if t_prev is None:
                        ttfts.append(now - t0)
                    else:
                        itls.append(now - t_prev)
                    t_prev = now
            n_done += 1

    await asyncio.gather(*(one_worker(w) for w in range(concurrency)))
    elapsed = max(time.monotonic() - t_start, 1e-9)
    return PerfPoint(
        isl=isl, osl=osl, concurrency=concurrency,
        ttft_p50_s=_pctl(ttfts, 0.50), ttft_p95_s=_pctl(ttfts, 0.95),
        itl_mean_s=(sum(itls) / len(itls)) if itls else 0.0,
        itl_p95_s=_pctl(itls, 0.95),
        req_per_s=n_done / elapsed,
        output_tok_per_s=n_done * osl / elapsed,
    )


async def profile_engine(
    engine,
    *,
    model_name: str = "",
    isls: Sequence[int] = (128, 512, 2048),
    osl: int = 32,
    concurrencies: Sequence[int] = (1, 2, 4, 8, 16),
    rounds: int = 2,
    warmup: bool = True,
    kv_cache_dtype: Optional[str] = None,
) -> PerfProfile:
    """Sweep the (isl, concurrency) grid.  `engine` is anything with the
    generate() contract; callers own its lifecycle.

    The profile is tagged with the engine's KV storage dtype (explicit
    `kv_cache_dtype` beats auto-detection off the engine) so the SLA
    planner can refuse to silently apply a bf16-measured ITL surface to
    an int8 fleet (planner/perf_model.py check_kv_dtype)."""
    if kv_cache_dtype is None:
        # TorchEngine exposes the EFFECTIVE dtype (engine/core.py
        # kv_dtype); an engine without one may carry it on its args
        kv_cache_dtype = getattr(engine, "kv_dtype", None) or getattr(
            getattr(engine, "args", None), "kv_cache_dtype", "")
    prof = PerfProfile(model_name=model_name,
                       meta={"osl": osl, "rounds": rounds,
                             "kv_cache_dtype": kv_cache_dtype})
    token_base = 0
    if warmup:
        # the first call pays the programs' first builds and pool
        # initialisation; don't let it pollute the smallest grid point
        await _measure_point(engine, int(isls[0]), 4, 1,
                             rounds=1, token_base=token_base)
        token_base += 10_000_000
    for isl in isls:
        for c in concurrencies:
            pt = await _measure_point(engine, int(isl), osl, int(c),
                                      rounds=rounds, token_base=token_base)
            token_base += 10_000_000
            prof.points.append(pt)
    return prof
