"""LoRA serving: adapter sources and batched multi-LoRA execution.

The counterpart of dynamo_tpu/lora/: a stacked adapter bank on the
device with a slot index per decode lane and per packed-prefill token
(`lora/bank.py`), so every request of a batch can use a different
adapter (or none) in the same captured program, and the PEFT directory
source the engine loads adapters from lazily (`lora/source.py`).  The
JAX package's `lora/routing.py` (rendezvous replica selection) belongs
to its KV router, which serves torch workers unchanged.
"""

from .bank import empty_bank, lora_delta  # noqa: F401
from .source import LocalLoraSource, LoraAdapter  # noqa: F401
