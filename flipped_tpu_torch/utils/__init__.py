from .metrics import MetricLogger, log_qtype

__all__ = ["MetricLogger", "log_qtype"]
