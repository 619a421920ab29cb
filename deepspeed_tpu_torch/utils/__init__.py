from .logging import log_dist, logger, warning_once

__all__ = ["log_dist", "logger", "warning_once"]
