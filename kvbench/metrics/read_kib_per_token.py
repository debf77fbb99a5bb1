"""KiB the accountant charged as read from the store in the window, per
output token: an exact count."""


def read(rec):
    return rec["read_bytes"] / rec["tokens"] / 1024 if rec["tokens"] else None
