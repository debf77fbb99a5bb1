"""Seconds from the harness's start to the window's: imports, kernel build,
weights, the adapter fit, the documents' admissions and the warm steps."""


def read(rec):
    return rec["setup_s"]
