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


def initLogging(filename, logger=None):
    """Attach a per-folder file handler (reference starfit.py:53-54,
    logger.py:7-27)."""
    if logger is None:
        logger = getLogger()
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()  # release the previous folder's starfit.log handle
    fh = logging.FileHandler(filename)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    return logger
