"""Fine-tuning on one card or a mesh of ranks: the next-token train step
with AdamW (``trainer.py``; dp, fsdp, tp, pp, sp and ep as the JAX
trainer takes them) and step-directory checkpoints, the same whatever
mesh wrote them, that the provider serves back (``checkpoint.py``).

Port of ``langstream_tpu/training``; reading an orbax checkpoint is not
ported (ROADMAP.md, A11).
"""

from langstream_tpu_torch.training.trainer import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig"]
