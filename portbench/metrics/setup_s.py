"""setup_s: from the start of the process to the first timed frame."""


def read(ctx):
    return ctx["setup_s"]
