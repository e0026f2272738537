"""Exception types of the port (counterpart of ``tpumetrics/utils/exceptions.py``)."""


class TPUMetricsUserError(Exception):
    """Error raised when a misuse of the metric API is detected (e.g. double sync)."""


class TPUMetricsUserWarning(UserWarning):
    """Warning raised for non-fatal metric API misuse or degraded behavior."""
