"""Small shared helpers (order statistics)."""
