"""Logging setup, as simplesr_tpu.utils.logger: a library logger and a
results logger with the same names ("simple_sr", "results"), each to a file
(``log``, ``results_logfile``) and to stdout, and an excepthook that logs
uncaught exceptions."""

import logging
import os
import sys

LIB_LOGGER = "simple_sr"
RESULTS_LOGGER = "results"


def setup_logger(log_dir=None, lib_level=logging.DEBUG, results_level=logging.INFO,
                 stdout=True):
    """Configure both loggers; file handlers only when ``log_dir`` is given."""
    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")

    def _configure(name, level, filename):
        logger = logging.getLogger(name)
        logger.setLevel(level)
        for handler in logger.handlers:
            handler.close()
        logger.handlers = []
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, filename))
            fh.setFormatter(formatter)
            logger.addHandler(fh)
        if stdout:
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(formatter)
            logger.addHandler(sh)
        return logger

    lib = _configure(LIB_LOGGER, lib_level, "log")
    results = _configure(RESULTS_LOGGER, results_level, "results_logfile")

    def handle_exception(exc_type, exc_value, exc_traceback):
        if issubclass(exc_type, KeyboardInterrupt):
            sys.__excepthook__(exc_type, exc_value, exc_traceback)
            return
        lib.error("Uncaught exception", exc_info=(exc_type, exc_value, exc_traceback))

    sys.excepthook = handle_exception
    return lib, results
