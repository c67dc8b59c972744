from .config import BarkConfig  # noqa: F401
from .model import Bark, BarkFineGPT, BarkGPT  # noqa: F401
