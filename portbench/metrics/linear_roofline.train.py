"""linear_roofline.train: the frozen linears' and LM head's least time at
the card's peaks over the device time of the linear kernel classes, in %."""
from pbcore.readers import linear_roofline as read  # noqa: F401
