"""Process start to the first timed query: imports, the card's context,
the kernel build or load, generation, the bulk load, the freeze and the
warm-up; host clock."""


def read(run):
    return run.setup_s
