"""Set-up: seconds from the process's start to the first timed request or
step (loading, weights, kernel builds, warm-up)."""


def read(rec):
    return rec["setup_s"]
