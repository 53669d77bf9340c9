"""Seconds from the process's start to the window's: imports, generation, the engine, warm-up, any build."""


def read(rec):
    return rec.setup_s
