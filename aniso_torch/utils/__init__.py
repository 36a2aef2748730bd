from .profiler import Profiler, timed, trace
from .logging import Logger, log
from .io import (
    write_result_csv,
    write_points_csv,
    load_result_csv,
    save_checkpoint,
    load_checkpoint,
)

__all__ = [
    "Profiler", "timed", "trace", "Logger", "log",
    "write_result_csv", "write_points_csv", "load_result_csv",
    "save_checkpoint", "load_checkpoint",
]
