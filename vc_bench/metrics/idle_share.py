"""idle_share.<cell>: the share of the traced window in which no operation
ran on the device: 1 - (union of kernel, copy and set intervals) / window."""


def read(record):
    tr = record["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
