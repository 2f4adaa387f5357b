r"""Console and file logger (``geotransformer_tpu/engine/logger.py``;
reference `engine/logger.py`). Rank 0 of a process group logs; the other
ranks' loggers hold a null handler, as the reference gates on its rank."""

import logging
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] %(message)s"


def create_logger(log_file=None, name="geotransformer_tpu_torch", process_index=0):
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.handlers.clear()
    if process_index != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
    for handler in handlers:
        handler.setLevel(logging.DEBUG)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger
