"""Data of the port (``repro.data`` counterpart): the deterministic
synthetic LM batch stream."""
from repro_torch.data.pipeline import DataPipeline, make_batch  # noqa: F401
