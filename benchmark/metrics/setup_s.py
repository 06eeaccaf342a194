"""setup_s: seconds from the start of the process to the first timed step
or request (host clock)."""


def read(run):
    return run["setup_s"]
