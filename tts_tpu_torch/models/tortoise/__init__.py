from .config import TortoiseConfig  # noqa: F401
from .model import Tortoise, UnifiedVoice  # noqa: F401
