"""Serving steps: the functions the serve launcher calls.

Port of the serving half of `repro/train/step.py`: `make_prefill_step`
and `make_decode_step`, each run under `torch.inference_mode()`. The
decode step takes the cache as JAX's jitted step takes it donated
(``donate_argnums=(2,)``): the new K/V rows are written into the cache's
tensors in place (`repro_torch.models.model.decode_step`).
`make_train_step` waits for the training slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, *, cache_len: int):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return M.prefill(params, batch, cfg, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache):
        with torch.inference_mode():
            return M.decode_step(params, token, cache, cfg)
    return decode_step
