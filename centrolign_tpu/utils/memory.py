"""Memory observability (reference utility.hpp:78-85, src/utility.cpp:161-
268): current/peak RSS, human formatting, and leveled logging — called at
every pipeline stage like the reference. On this backend the accelerator's
HBM watermark is reported too when a device is attached (the scaling
constraints here are host RSS *and* HBM)."""

from __future__ import annotations

import os
import resource

from .. import logging as logmod


def current_memory_usage() -> int:
    """Resident set size in bytes (reference src/utility.cpp:161)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return -1


def max_memory_usage() -> int:
    """Peak RSS in bytes (reference src/utility.cpp:202, getrusage)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_maxrss * 1024  # linux reports KiB


def format_memory_usage(mem: int) -> str:
    """Reader-friendly size (reference src/utility.cpp:222-246)."""
    memd = float(mem)
    for unit in ("", "k", "M", "G", "T", "P"):
        if memd < 1024.0 or unit == "P":
            return f"{memd:.2f} {unit}B"
        memd /= 1024.0


def hbm_usage() -> int:
    """Bytes in use on the first device, or -1 when this process has not
    imported JAX (a memory report must not start the device on its own)
    or the backend keeps no statistics."""
    import sys
    if "jax" not in sys.modules:
        return -1
    import jax
    stats = jax.local_devices()[0].memory_stats()
    return int(stats.get("bytes_in_use", -1)) if stats else -1


def log_memory_usage(level: int) -> None:
    """(reference src/utility.cpp:248-268)"""
    if logmod.level < level:
        return
    peak = max_memory_usage()
    if peak < 0:
        logmod.log(level, "Failed to measure peak memory usage.")
    else:
        logmod.log(level, "Peak memory usage so far: "
                   + format_memory_usage(peak) + ".")
    if level == logmod.Debug:
        curr = current_memory_usage()
        if curr < 0:
            logmod.log(level, "Failed to measure current memory usage.")
        else:
            logmod.log(level, "Current memory usage: "
                       + format_memory_usage(curr) + ".")
        hbm = hbm_usage()
        if hbm >= 0:
            logmod.log(level, "Current device HBM usage: "
                       + format_memory_usage(hbm) + ".")
