from .geometric_verification import geometric_verification  # noqa: F401
from .image import Image, ImageList  # noqa: F401
from .logger import change_logger_level, setup_logger  # noqa: F401
from .timer import Timer, timeit  # noqa: F401
