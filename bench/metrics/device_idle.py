"""Share of the traced window in which no kernel, copy or fill ran on the
card, in %.  The reader of every ``device_idle.<cell kind>`` metric."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
