from .config import EngineConfig
from .core import TorchEngine
from .worker import TorchEngineWorker

__all__ = ["EngineConfig", "TorchEngine", "TorchEngineWorker"]
