"""Fault-tolerant training loop, as ``repro.train.loop``.

  - a checkpoint every ``ckpt_every`` steps and at the end (atomic, keep-k);
  - on ANY step failure, a non-finite loss included: restore the latest
    checkpoint and go on (re-initialise when there is none), up to
    ``max_retries`` failures in a row. The data is step-keyed, so the
    replay is exact: ``TokenPipeline.batch_at(step)``, and whisper's frames
    and qwen2-vl's vision embeddings from a ``torch.Generator`` seeded by
    (seed, step) (the reference draws them with ``jax.random``, whose
    numbers torch cannot reproduce);
  - a watchdog: steps slower than ``watchdog_s`` are listed in
    ``slow_steps``.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                               "repro_torch_ckpt"))
    ckpt_every: int = 25
    keep: int = 3
    watchdog_s: float = 600.0
    max_retries: int = 3
    bf16_grads: bool = True
    microbatch: int = 1
    peak_lr: float = 3e-4
    seed: int = 0
    device: str | None = None  # None: the card


@dataclass
class TrainResult:
    losses: list = field(default_factory=list)
    restarts: int = 0
    slow_steps: list = field(default_factory=list)
    final_step: int = 0


def batch_at(cfg: ArchConfig, tcfg: TrainConfig, pipeline: TokenPipeline, step: int,
             device) -> dict:
    """The batch of ``step``: the pipeline's tokens and the family's modality
    input, bf16 normal draws from a generator seeded by (seed, step)."""
    batch = {"tokens": torch.as_tensor(pipeline.batch_at(step), device=device)}
    extra = {"encdec": ("frames", cfg.cross_len), "vlm": ("vision_embeds", cfg.n_vision_tokens)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        gen = torch.Generator(device=device).manual_seed(tcfg.seed * 1_000_003 + step)
        batch[key] = torch.randn((tcfg.batch, n, cfg.d_model), generator=gen,
                                 device=device, dtype=torch.bfloat16)
    return batch


def train(cfg: ArchConfig, tcfg: TrainConfig, fail_injector=None) -> TrainResult:
    """``fail_injector(step) -> bool`` lets tests simulate node failures."""
    device = resolve_device(tcfg.device)

    def fresh():
        params = M.init_params(cfg, seed=tcfg.seed, device=device)
        return params, adamw_init(params)

    params, opt = fresh()
    pipeline = TokenPipeline(cfg.vocab_size, tcfg.batch, tcfg.seq_len, seed=tcfg.seed)
    step_fn = make_train_step(cfg, bf16_grads=tcfg.bf16_grads, microbatch=tcfg.microbatch,
                              peak_lr=tcfg.peak_lr, total_steps=tcfg.steps)
    result = TrainResult()
    step = 0
    start = CKPT.latest_step(tcfg.ckpt_dir)
    if start is not None:
        params, opt = CKPT.restore_checkpoint(tcfg.ckpt_dir, start, (params, opt))
        step = start

    retries = 0
    while step < tcfg.steps:
        batch = batch_at(cfg, tcfg, pipeline, step, device)
        t0 = time.time()
        try:
            if fail_injector is not None and fail_injector(step):
                raise RuntimeError(f"injected failure at step {step}")
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        except Exception:  # any step failure: restore and go on, up to max_retries
            result.restarts += 1
            retries += 1
            if retries > tcfg.max_retries:
                raise
            latest = CKPT.latest_step(tcfg.ckpt_dir)
            if latest is not None:
                params, opt = CKPT.restore_checkpoint(tcfg.ckpt_dir, latest, (params, opt))
                step = latest
            else:
                params, opt = fresh()
                step = 0
            continue
        retries = 0
        if time.time() - t0 > tcfg.watchdog_s:
            result.slow_steps.append(step)  # straggler log (skip-coherent)
        result.losses.append(loss)
        step += 1
        if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
            CKPT.save_checkpoint(tcfg.ckpt_dir, step, (params, opt), keep=tcfg.keep)
    result.final_step = step
    return result
