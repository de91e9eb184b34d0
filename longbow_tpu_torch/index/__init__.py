"""Vector indexes (the flat index so far)."""
