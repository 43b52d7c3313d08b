"""Wall ms per step of the gradient compression, synchronised on both
sides."""


def read(rec):
    s = rec.get("compress_s")
    return 1e3 * sum(s) / len(s) if s else None
