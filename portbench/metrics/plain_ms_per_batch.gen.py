"""plain_ms_per_batch.gen: device ms a generated batch of the kernels in
no class (the plain layers)."""
from pbcore.readers import plain_ms_per_unit as read  # noqa: F401
