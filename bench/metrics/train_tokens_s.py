"""Tokens of the window's training steps over the time from the first
step's start to the last one's synchronised end."""


def read(rec):
    return rec["tokens"] / (rec["t1"] - rec["t0"])
