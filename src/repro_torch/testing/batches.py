"""Batches that neither package's ``Trainer`` draws: the vlm's vision
embeddings beside its tokens, and the audio family's frame embeddings in
place of them. ``with_vision`` and ``with_frames`` wrap a trainer's
``synthetic_batch`` (either package's: they touch only its numpy draws), so
that the trainer, its LB ingest and its checkpoints drive those families;
the ingest scatters the extra field with the rows it belongs to. The extra
draws come from the trainer's own generator after its draws, so a run
restarted from its seed draws the same batches."""
from __future__ import annotations

import numpy as np


def with_vision(tr):
    """Each batch of ``tr`` (a vlm's trainer) gets ``vision_embeds``
    [batch, n_vision_tokens, d_model] float32 rows, one per event."""
    cfg, draw = tr.model_cfg, tr.synthetic_batch

    def synthetic_batch(batch: int, seq: int, rng: np.random.Generator):
        b = draw(batch, seq, rng)
        b["vision_embeds"] = rng.standard_normal(
            (batch, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
        return b

    tr.synthetic_batch = synthetic_batch
    return tr


def with_frames(tr):
    """Each batch of ``tr`` (an encoder's trainer) carries ``embeds``
    [batch, seq, d_model] float32 frames in place of its tokens; the
    labels stay the drawn tokens (per-frame targets)."""
    cfg, draw = tr.model_cfg, tr.synthetic_batch

    def synthetic_batch(batch: int, seq: int, rng: np.random.Generator):
        b = draw(batch, seq, rng)
        del b["tokens"]
        b["embeds"] = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)
        return b

    tr.synthetic_batch = synthetic_batch
    return tr
