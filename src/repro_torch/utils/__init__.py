"""Small shared helpers (order statistics, byte sizes)."""
