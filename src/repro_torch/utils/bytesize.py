"""Byte-size helpers used across memory accounting and the tuner."""

KiB = 1024
MiB = 1024 * KiB
GiB = 1024 * MiB


def fmt_bytes(n: float) -> str:
    """Human-readable byte count (binary units)."""
    n = float(n)
    for unit, div in (("GiB", GiB), ("MiB", MiB), ("KiB", KiB)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"
