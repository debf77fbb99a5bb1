"""KVSwap core in PyTorch: engine, predictor, low-rank adapter, and the host
layer (disk store, reuse and rolling buffers, mapping-table manager)."""
