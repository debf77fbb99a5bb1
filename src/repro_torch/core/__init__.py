"""KVSwap core in PyTorch: engine, predictor, low-rank adapter, the offline
tuner, the paper's baselines, and the host layer (disk store, reuse and
rolling buffers, mapping-table manager)."""

from repro_torch.core.predictor import PredictorConfig, predict_groups

__all__ = ["PredictorConfig", "predict_groups"]
