"""mfu.train: the model FLOPs' least time at the card's peaks over the traced
window, in %."""
from pbcore.readers import mfu as read  # noqa: F401
