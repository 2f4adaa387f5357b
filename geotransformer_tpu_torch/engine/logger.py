r"""Console and file logger (``geotransformer_tpu/engine/logger.py``;
reference `engine/logger.py`). One process group: this process logs."""

import logging
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] %(message)s"


def create_logger(log_file=None, name="geotransformer_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.handlers.clear()
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
    for handler in handlers:
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger
