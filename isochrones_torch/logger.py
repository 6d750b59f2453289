"""Logging for isochrones_torch (counterpart of ``isochrones_tpu/logger.py``)."""

import logging

_logger = None


def getLogger(name="isochrones_torch"):
    global _logger
    if _logger is None:
        _logger = logging.getLogger(name)
        if not _logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
            _logger.addHandler(handler)
            _logger.setLevel(logging.INFO)
    return _logger
