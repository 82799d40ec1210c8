"""Process start to the first input of the window: imports, the card, the
program's builds or loads, the scene or packets, the warm-up revolutions."""


def read(run):
    return run.setup_s
