"""Optimizer of the port (``repro.optim`` counterpart): AdamW with
global-norm clipping, the warmup-stable-decay schedule and the int8
gradient-compression hooks."""
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     compress_stochastic_int8,
                                     decompress_int8, wsd_schedule)
