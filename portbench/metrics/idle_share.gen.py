"""idle_share.gen: the share of the traced window with no operation on the
card, in %."""
from pbcore.readers import idle_share as read  # noqa: F401
