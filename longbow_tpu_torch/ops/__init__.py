"""Distance, top-k and fused-scan operators on torch tensors."""
