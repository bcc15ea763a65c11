"""Megabytes all-reduced per step on rank 0 (the program's counter
``dp.allreduce_bytes`` over the window's steps); None where the program
keeps no such counter."""


def read(run):
    per_step = run.outcome.counters.get("allreduce_bytes_per_step")
    return per_step / 1e6 if per_step else None
