"""Subproblem data-parallelism over independent guide-tree siblings (the
reference executes them serially, src/execution.cpp:83-124): each layer of
the guide tree fans out over a pool of worker processes, one card each
(parallel/scheduler.py)."""

from .scheduler import distributed_execute  # noqa: F401
