"""plain_ms_per_update.train: device ms an update of the kernels in no
class (the plain layers)."""
from pbcore.readers import plain_ms_per_unit as read  # noqa: F401
