"""Seconds from the process's start to the window's start: imports, the
kernel library (built on a checkout's first run), the corpus made on
the device, the index and one warm-up call of each size the mix uses."""


def read(run):
    return run.setup_s
