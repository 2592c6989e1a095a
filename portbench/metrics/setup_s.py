"""setup_s: seconds from the process's start to the window's: the card,
the kernels' build or cache, the cell's inputs and state, the warm-up."""


def read(rec):
    return rec.setup_s
