from .config import EngineConfig
from .core import TorchEngine

__all__ = ["EngineConfig", "TorchEngine"]
