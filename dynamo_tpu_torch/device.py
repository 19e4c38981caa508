"""Device choice for the port's entry points.

Every entry point takes an explicit `device` and defaults to CUDA.  The
CPU is used only when the caller asks for it (the CPU tests do).  When
CUDA is asked for and absent this raises: the port never falls back to
the CPU on its own, because a CPU run of a serving path would report
numbers no user could get from it.
"""

from __future__ import annotations

import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# CUPTI, which torch.profiler's CUDA tracing drives, can deadlock when
# the profiler starts or stops while another thread is inside a CUDA
# graph launch: on the H100 a /debug/profile capture hung with the
# profiler's stop and a decode program's graph.replay() both stuck.
# Every graph replay (engine/graphs.py) and every start and stop of the
# status server's profiler (runtime/system_status.py) hold this lock,
# so neither runs inside the other.
PROFILER_GRAPH_LOCK = threading.Lock()


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch.device for `device`, or a RuntimeError when CUDA is
    requested on a machine without a usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda is not "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "expected 'cuda', 'cuda:N' or 'cpu'")
    return dev
